"""The fused profile: the port's fused layer-step against the JAX package.

On the CPU the fused wrapper runs its plain version: the plain window,
then 45 fp32 tap products accumulated in tap order. With the shared
bias/PReLU epilogue it must match, for the input plane, a hidden layer and
the output layer at the first, a middle and the last step, both the JAX
package's fused Pallas kernel (``_fused_conv``, interpret mode) and its
gather conv (``_frontier_conv``), at rtol = atol = 2e-5: the tolerance
the JAX package holds its own fused kernel to
(``test_fused_conv_matches_gather_cells``), since only the order of the
fp32 sums differs. The fused profile's own roundtrip is bit-exact, its
streams carry their own profile bit, and each profile refuses the
other's streams. The CUDA kernel itself runs only on a card:
tests/test_torch_gpu.py holds it against the plain version there.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pseudocylindrical_convolution_tpu.codec import container as jcontainer
from pseudocylindrical_convolution_tpu.codec.wavefront_scan import (
    ScanWavefrontCodec as JaxScan)

from pseudocylindrical_convolution_torch.codec import container
from pseudocylindrical_convolution_torch.codec import fused_kernel as fk
from pseudocylindrical_convolution_torch.codec import window_kernel as wk
from pseudocylindrical_convolution_torch.codec.wavefront import (
    wavefront_schedule)
from pseudocylindrical_convolution_torch.codec.wavefront_scan import (
    ScanWavefrontCodec, bias_prelu, get_scan_codec, scan_decode_images,
    scan_encode_images)
from pseudocylindrical_convolution_torch.utils.checkpoint import load_model

from torch_parity import CFG, JCFG, jax_params, numpy_tree

H, W, B, L = 2, 16, 2, 4
FUSED2 = container.FLAG2_TORCH | container.FLAG2_TORCH_FUSED


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread keeps torch from
    spinning a thread pool against the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return load_model(numpy_tree(2), CFG, device="cpu")


@pytest.fixture(scope="module")
def valid():
    m = np.zeros((CFG.npart, CFG.ngroup, H, W), bool)
    for b, wl in enumerate(CFG.geometry().hindex(H * CFG.npart, W)):
        m[b, :, :, :int(wl)] = True
    return m


@pytest.fixture(scope="module")
def codecs(model):
    params = jax_params(2)
    jf = JaxScan(JCFG, JCFG.geometry(), H, W, batch=B, lanes=L,
                 dtype=jnp.float32, window_mode="fused", conv_chunks=1)
    jg = JaxScan(JCFG, JCFG.geometry(), H, W, batch=B, lanes=L,
                 dtype=jnp.float32, window_mode="gather", conv_chunks=1)
    jf.prepare(params["ent"])
    jg.prepare(params["ent"])
    tc = ScanWavefrontCodec(CFG, CFG.geometry(), H, W, batch=B, lanes=L,
                            dtype=torch.float32, device="cpu",
                            window_mode="fused").prepare(model.ent)
    return jf, jg, tc


def _planes(seed):
    return np.random.default_rng(seed).integers(
        0, 8, (B, CFG.npart, CFG.ngroup, H, W))


@pytest.mark.parametrize("li", [0, 1, 11])
def test_fused_plain_matches_jax(codecs, li):
    """Input plane, hidden layer, output layer; steps first, mid, last."""
    jf, jg, tc = codecs
    geom = CFG.geometry()
    CC = CFG.ngroup if li == 0 else 3 * CFG.ngroup * tc.cpn
    rng = np.random.default_rng(300 + li)
    core = rng.standard_normal((B, geom.npart, H, W, CC)).astype(np.float32)
    for b, wl in enumerate(geom.hindex(H * geom.npart, W)):
        core[:, b, :, int(wl):] = 0.0      # never written in a real run
    core = core.reshape(B, jg.S, CC)
    # the JAX fused buffer has zero margins; the port's random ones, and a
    # random trash row, which nothing may read
    jbuf = np.zeros((B, jf.Sbuf, CC), np.float32)
    jbuf[:, jf._row_off:jf._row_off + jf.S] = core
    pbuf = rng.standard_normal((B, tc.Sbuf, CC)).astype(np.float32)
    M1 = tc.tabs.row_off
    pbuf[:, M1:M1 + jg.S] = core
    layer = tc._weights[li]
    for z in (0, tc.nsteps // 2, tc.nsteps - 1):
        got = bias_prelu(fk.fused(torch.as_tensor(pbuf), z, tc.tabs,
                                  layer["kf"]), layer).numpy()
        want_f = np.asarray(jf._fused_conv(jnp.asarray(jbuf), jnp.int32(z),
                                           jf._weights[li]))
        want_g = np.asarray(jg._frontier_conv(jnp.asarray(core),
                                              jnp.int32(z), jg._weights[li]))
        np.testing.assert_allclose(got, want_f, rtol=2e-5, atol=2e-5,
                                   err_msg=f"fused, layer {li}, step {z}")
        np.testing.assert_allclose(got, want_g, rtol=2e-5, atol=2e-5,
                                   err_msg=f"gather, layer {li}, step {z}")


@pytest.mark.parametrize("dtype,seed", [(torch.float32, 21),
                                        (torch.bfloat16, 22)])
def test_fused_roundtrip_files(model, valid, tmp_path, dtype, seed):
    """encode_files -> decode_files is bit-exact; the stream carries the
    fused profile bit; a window-profile codec refuses it, and the fused
    codec refuses a window-profile stream."""
    fused = ScanWavefrontCodec(CFG, CFG.geometry(), H, W, batch=B, lanes=L,
                               dtype=dtype, device="cpu",
                               window_mode="fused").prepare(model.ent)
    plain = ScanWavefrontCodec(CFG, CFG.geometry(), H, W, batch=B, lanes=L,
                               dtype=dtype, device="cpu").prepare(model.ent)
    planes = _planes(seed)
    fns = [str(tmp_path / f"f{i}.bin") for i in range(B)]
    sizes = fused.encode_files(planes, fns)
    assert sizes == [os.path.getsize(f) for f in fns]
    assert container.read_stream(fns[0])["flags2"] == FUSED2
    dec = fused.decode_files(fns)
    assert ((dec == planes) | ~valid[None]).all()
    # one stream in a B-slot codec
    assert ((fused.decode_files(fns[1:])[0] == planes[1]) | ~valid).all()
    with pytest.raises(ValueError, match="profile"):
        plain.decode_files(fns)
    wfn = str(tmp_path / "w.bin")
    plain.encode_files(planes, [wfn])
    assert container.read_stream(wfn)["flags2"] == container.FLAG2_TORCH
    with pytest.raises(ValueError, match="profile"):
        fused.decode_files([wfn])


@pytest.fixture(scope="module")
def image_stream(model, tmp_path_factory):
    """One image through the default profile's image API: its stream file,
    symbol planes and reconstruction."""
    x = np.random.default_rng(31).uniform(size=(1, 3, 64, 128)).astype(
        np.float32)
    ref = str(tmp_path_factory.mktemp("image") / "ref.bin")
    _, planes = scan_encode_images(model, [x], CFG.geometry(), [ref],
                                   device="cpu", return_planes=True)
    rec = scan_decode_images(model, CFG.geometry(), [ref], (64, 128),
                             device="cpu")
    return ref, planes, rec


@pytest.mark.parametrize("window_mode", ["window", "fused"])
def test_scan_decode_images_picks_profile(model, image_stream, tmp_path,
                                          window_mode):
    """scan_decode_images rebuilds the codec the header names; both
    profiles give the same latents, so the same reconstruction."""
    ref, planes, rec0 = image_stream
    h, w = planes.shape[3:]
    codec = get_scan_codec(CFG, CFG.geometry(), h, w, 1,
                           container.read_stream(ref)["lanes"],
                           device="cpu", window_mode=window_mode)
    assert codec.window_mode == window_mode
    fn = str(tmp_path / "s.bin")
    codec.prepare(model.ent).encode_files(planes, [fn])
    want2 = FUSED2 if window_mode == "fused" else container.FLAG2_TORCH
    assert container.read_stream(fn)["flags2"] == want2
    rec, dplanes = scan_decode_images(model, CFG.geometry(), [fn], (64, 128),
                                      device="cpu", return_planes=True)
    np.testing.assert_array_equal(dplanes, planes)
    np.testing.assert_array_equal(rec.numpy(), rec0.numpy())


@pytest.mark.parametrize("bit,name", [
    (jcontainer.FLAG2_FUSEDSTEP, "fused window\\+conv step"),
    (jcontainer.FLAG2_FUSEDUNROLL, "fused unrolled")])
def test_jax_fused_bits_refused(tmp_path, bit, name):
    """The JAX fused-step bits stay refused by name, alone or beside the
    port's own fused bit."""
    for extra in (0, container.FLAG2_TORCH_FUSED):
        fn = str(tmp_path / f"{bit}-{extra}.bin")
        container.write_stream(fn, container.MODE_SCAN, 4, 8, H, W,
                               b"\0" * 8, lanes=1, batch=1, lane_nbytes=[8],
                               flags2=bit | extra)
        with pytest.raises(ValueError, match=name):
            container.read_stream(fn)
    assert container.FLAG2_TORCH_FUSED not in (
        jcontainer.FLAG2_MMPAD, jcontainer.FLAG2_PALLASWIN,
        jcontainer.FLAG2_FUSEDSTEP, jcontainer.FLAG2_FUSEDUNROLL)


def test_fused_wrapper_takes_plain_version_on_cpu_only(codecs):
    _, _, tc = codecs
    buf = torch.randn(B, tc.Sbuf, 3 * CFG.ngroup * tc.cpn)
    k = tc._weights[3]["kf"]
    before = fk.launches
    np.testing.assert_array_equal(fk.fused(buf, 5, tc.tabs, k).numpy(),
                                  fk.fused_plain(buf, 5, tc.tabs, k).numpy())
    assert fk.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fk.fused_cuda(buf, 5, tc.tabs, k)
    with pytest.raises(ValueError):
        fk.fused(buf.to("meta"), 5, tc.tabs, k)


def test_fused_bytes_and_flops(codecs):
    """The bound's counts: K, the cells and the source rows at least; the
    operations two per term of every cell."""
    _, _, tc = codecs
    CC = 3 * CFG.ngroup * tc.cpn
    buf = torch.zeros(1, tc.Sbuf, CC)
    k = tc._weights[1]["kf"]
    cells = tc.npart * H * 3 * CFG.ngroup * k.shape[2]
    n = fk.fused_bytes(buf, tc.nsteps // 2, tc.tabs, k)
    assert k.numel() * 4 + cells * 4 < n < k.numel() * 4 + cells * 4 + (
        tc.Sbuf + tc.npart * H * 6 + 4096) * CC * 4
    assert fk.fused_flops(buf, tc.tabs, k) == 2 * cells * 45 * (CC // 3)


@pytest.mark.parametrize("width", ["hidden", "input"])
def test_fused_ordered_within_tol_of_plain(width):
    """The kernel's sum order (fused_ordered, bf16) stays within TOL x
    sum|products| of the tap-order plain version at every step."""
    geom = CFG.geometry()
    G = CFG.ngroup
    _, _, nsteps = wavefront_schedule(geom, H, W, G)
    tabs = wk.build_window_tables(geom, H, W, G, nsteps, torch.bfloat16,
                                  "cpu")
    CC, CI = (9 * G, 3 * G) if width == "hidden" else (G, G)
    rng = np.random.default_rng(41 if width == "hidden" else 42)
    buf = torch.as_tensor(rng.standard_normal((B, tabs.Sbuf, CC)),
                          dtype=torch.float32).to(torch.bfloat16)
    k = torch.as_tensor(rng.standard_normal((3 * G, 45 * CI, 3))
                        / np.sqrt(45 * CI),
                        dtype=torch.float32).to(torch.bfloat16)
    for z in range(nsteps):
        got = fk.fused_ordered(buf, z, tabs, k)
        err = (got - fk.fused_plain(buf, z, tabs, k)).abs()
        assert (err <= fk.fused_tolerance(buf, z, tabs, k)).all(), z
        assert got.shape == (B, geom.npart, H, 3 * G * 3)


# Terms of one cell (q: value) whose fp32 sum depends on the order, with
# the sum in the kernel's order and in plain sequence. 2^24 + 1 rounds to
# 2^24, so a 1 survives only where it is not added to 2^24 first.
BIG = 2.0 ** 24
ORDER_CASES = {
    # thread 0 adds q=0 and q=256 (they cancel), thread 1 holds the 1
    "strided_shares": ({0: BIG, 1: 1.0, 256: -BIG}, 1.0, 0.0),
    # lanes 0 and 16 cancel in the butterfly's first round
    "butterfly": ({0: BIG, 1: 1.0, 16: -BIG}, 1.0, 0.0),
    # warps 0, 2, 3 added in warp order: (1 + 2^24) - 2^24 = 0, where a
    # pairwise tree over the warps would give (1 + 0) + (2^24 - 2^24) = 1
    "warp_order": ({0: 1.0, 64: BIG, 96: -BIG}, 0.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_fused_ordered_takes_the_kernel_order(case):
    """A hand-built cell: an all-ones window, K holding the terms. The
    ordered contraction gives the strided -> butterfly -> warp-order sum,
    not the sequential one."""
    terms, want, sequential = ORDER_CASES[case]
    CI = 8                                  # 360 terms: two thread trips
    win = torch.ones((1, 1, 5, 9, CI), dtype=torch.bfloat16)  # h=1, G=1
    k = torch.zeros((3, 45 * CI, 1), dtype=torch.bfloat16)
    for q, v in terms.items():
        k[1, q, 0] = v                      # subnet 1's cell
    got = fk.contract_ordered(win, k).reshape(3)
    assert got.tolist() == [0.0, want, 0.0]
    seq = torch.zeros((), dtype=torch.float32)
    for v in k[1, :, 0].float():
        seq = seq + v
    assert float(seq) == sequential
    assert float(fk.ordered_sum(k[1, :, 0].float())) == want


def test_fused_ordered_is_bf16_only():
    win = torch.ones((1, 1, 5, 9, 8))
    with pytest.raises(TypeError, match="bf16"):
        fk.contract_ordered(win, torch.zeros((3, 360, 1)))


def test_window_mode_is_checked_and_keyed():
    with pytest.raises(ValueError, match="window_mode"):
        ScanWavefrontCodec(CFG, CFG.geometry(), H, W, device="cpu",
                           window_mode="fusedu")
    a = get_scan_codec(CFG, CFG.geometry(), H, W, 1, L, device="cpu")
    b = get_scan_codec(CFG, CFG.geometry(), H, W, 1, L, device="cpu",
                       window_mode="fused")
    assert (a.window_mode, b.window_mode) == ("window", "fused")
    assert a.profile_flags2 == container.FLAG2_TORCH
    assert b.profile_flags2 == FUSED2
