"""The PyTorch port's slice end to end on the CPU, against the JAX package.

  * Roundtrips: the port's own encode -> decode is bit-exact (symbols
    equal) in fp32 and bf16, in batch slots (on the CPU the window is the
    kernel's plain version).
  * Against the JAX scan codec (window_mode="gather", fp32), same inputs:
    the per-symbol coder ranges (the CDF rows at the coded symbols) are
    equal but for counted rows -- bit-exactness is per executable, and the
    frameworks' fp32 conv sums and erf differ in the last bits, which moves
    an integer CDF entry wherever 65536*p + 0.5 sits that close to an
    integer (see test_torch_ops.py::test_gmm_cdf_table_rows).
  * The image path: latents equal the JAX package's, the stream file
    decodes to the same symbols, and the reconstruction is allclose to the
    JAX decoder's (rtol 1e-4, atol 1e-5, as in test_torch_models.py).
  * Each package refuses the other's streams; entry points run on the card
    unless told otherwise; the port imports no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pseudocylindrical_convolution_tpu.codec import container as jcontainer
from pseudocylindrical_convolution_tpu.codec.pipeline import (
    _table_program)
from pseudocylindrical_convolution_tpu.codec.wavefront_scan import (
    ScanWavefrontCodec as JaxScan)

from pseudocylindrical_convolution_torch.codec import container
from pseudocylindrical_convolution_torch.codec import pipeline as pl
from pseudocylindrical_convolution_torch.codec.wavefront_scan import (
    ScanWavefrontCodec, scan_decode_images, scan_encode_images)
from pseudocylindrical_convolution_torch.models.entropy import fused_weights
from pseudocylindrical_convolution_torch.utils.checkpoint import load_model

from torch_parity import (CFG, JCFG, jax_decode_latents, jax_encode_latents,
                          jax_params, numpy_tree)

H, W, B, L = 2, 16, 2, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    return load_model(numpy_tree(1), CFG, device="cpu")


@pytest.fixture(scope="module")
def valid():
    m = np.zeros((CFG.npart, CFG.ngroup, H, W), bool)
    for b, wl in enumerate(CFG.geometry().hindex(H * CFG.npart, W)):
        m[b, :, :, :int(wl)] = True
    return m


def _planes(seed):
    return np.random.default_rng(seed).integers(
        0, 8, (B, CFG.npart, CFG.ngroup, H, W))


@pytest.mark.parametrize("dtype,seed", [
    (torch.float32, 1), (torch.float32, 2),
    (torch.bfloat16, 3), (torch.bfloat16, 4)])
def test_roundtrip(model, valid, dtype, seed):
    codec = ScanWavefrontCodec(CFG, CFG.geometry(), H, W, batch=B, lanes=L,
                               dtype=dtype, device="cpu")
    codec.prepare(model.ent)
    planes = _planes(seed)
    streams = codec.encode_planes(planes)
    dec = codec.decode_streams(streams)
    assert ((dec == planes) | ~valid[None]).all()
    # one real stream in a B-slot codec, and the slots in another order
    assert ((codec.decode_streams([streams[1]])[0] == planes[1])
            | ~valid).all()
    dec_r = codec.decode_streams([streams[1], streams[0]])
    assert ((dec_r[0] == planes[1]) | ~valid).all()
    assert ((dec_r[1] == planes[0]) | ~valid).all()


def test_coder_ranges_and_tables_against_jax(model, valid):
    """The port's per-step CDF rows equal the port's own dense tables
    (fp32, the counterpart of the JAX package's
    test_scan_tables_match_dense_program), the JAX dense tables and the
    JAX scan codec's coder ranges, but for counted rows (at most 5%)."""
    params = jax_params(1)
    jc = JaxScan(JCFG, JCFG.geometry(), H, W, batch=B, lanes=L,
                 dtype=jnp.float32, window_mode="gather", conv_chunks=2)
    jc.prepare(params["ent"])
    tc = ScanWavefrontCodec(CFG, CFG.geometry(), H, W, batch=B, lanes=L,
                            dtype=torch.float32, device="cpu")
    tc.prepare(model.ent)
    planes = _planes(11) * valid[None]
    _, want = jc._run(jnp.zeros((B * jc.NW,), jnp.uint32),
                      jnp.zeros((B, L), jnp.int32),
                      jnp.zeros((B, L), jnp.uint32),
                      jnp.asarray(planes.reshape(B, -1).astype(np.int32)),
                      decode=False)
    want = np.asarray(want).astype(np.int64)
    tabs = []
    _, got = tc.run(teacher=torch.as_tensor(planes.reshape(B, -1)),
                    tables_out=tabs)
    got = got.numpy()
    nsym = want.shape[1]
    differ = int((want != got).sum())
    assert differ <= B * nsym * 5 // 100, differ
    # the tables against the JAX dense (one-shot) program on the same plane
    dense = np.asarray(_table_program(
        params["ent"], jnp.asarray(planes.reshape(
            B, CFG.npart, CFG.ngroup, H, W).astype(np.float32) - 3.5),
        JCFG, JCFG.geometry()))
    rows = torch.cat(tabs, dim=1).numpy()
    assert rows.shape == dense.shape == (B, nsym, 9)
    differ = int((rows != dense).any(axis=2).sum())
    assert differ <= B * nsym * 5 // 100, differ
    assert np.abs(rows - dense).max() <= 2
    # ... and against the port's own dense program on the same planes:
    # two different torch programs, so rows may differ by 1 where the
    # fp32 sums reassociate (5 of 432 rows at this seed)
    sched = pl._Schedule(CFG.geometry(), H, W, CFG.ngroup, "cpu")
    own = pl._table_body(fused_weights(model.ent, CFG.ngroup),
                         torch.as_tensor(planes.reshape(
                             B, CFG.npart, CFG.ngroup, H, W).astype(
                             np.float32) - 3.5), CFG.geometry(),
                         sched).numpy()
    assert own.shape == rows.shape
    differ = int((rows != own).any(axis=2).sum())
    assert differ <= B * nsym * 5 // 100, differ
    assert np.abs(rows - own).max() <= 1


def test_image_path_against_jax(model, tmp_path):
    """Image -> latents -> stream file -> latents -> image."""
    params = jax_params(1)
    x = np.random.default_rng(5).uniform(size=(1, 3, 64, 128)).astype(
        np.float32)
    fns = [str(tmp_path / "a.bin"), str(tmp_path / "b.bin")]
    sizes, planes = scan_encode_images(model, [x, x[:, :, :, ::-1].copy()],
                                       CFG.geometry(), fns, device="cpu",
                                       return_planes=True)
    assert sizes == [os.path.getsize(f) for f in fns]
    hcode = np.asarray(jax_encode_latents(params, jnp.asarray(x), JCFG,
                                          JCFG.geometry()))
    np.testing.assert_array_equal(planes[0], hcode.reshape(planes[0].shape))
    rec, dplanes = scan_decode_images(model, CFG.geometry(), fns, (64, 128),
                                      device="cpu", return_planes=True)
    np.testing.assert_array_equal(dplanes, planes)
    want = np.asarray(jax_decode_latents(params, jnp.asarray(hcode), JCFG,
                                         JCFG.geometry()))
    np.testing.assert_allclose(rec[:1].numpy(), want, rtol=1e-4, atol=1e-5)
    hdr = container.read_stream(fns[0])
    assert hdr["flags2"] == container.FLAG2_TORCH
    assert hdr["flags"] & container.FLAG_BF16


def test_streams_refused_across_packages(model, tmp_path):
    # a JAX-package stream: the port refuses it by its missing profile bit
    jfn = str(tmp_path / "jax.bin")
    jcontainer.write_stream(jfn, jcontainer.MODE_SCAN, 4, 8, H, W, b"\0" * 8,
                            lanes=1, batch=1, lane_nbytes=[8],
                            flags=jcontainer.FLAG_BF16)
    with pytest.raises(ValueError, match="JAX package"):
        container.read_stream(jfn)
    # JAX-only profiles are refused by name
    for flags, flags2, name in ((jcontainer.FLAG_BURST, 0, "burst"),
                                (jcontainer.FLAG_SLAB, 0, "slab"),
                                (jcontainer.FLAG_HOIST, 0, "hoist"),
                                (0, jcontainer.FLAG2_MMPAD, "mm pad"),
                                (0, jcontainer.FLAG2_PALLASWIN, "Pallas"),
                                (0, jcontainer.FLAG2_FUSEDSTEP, "fused")):
        fn = str(tmp_path / f"{name}.bin")
        container.write_stream(fn, container.MODE_SCAN, 4, 8, H, W,
                               b"\0" * 8, lanes=1, batch=1, lane_nbytes=[8],
                               flags=flags, flags2=flags2)
        with pytest.raises(ValueError, match=name):
            container.read_stream(fn)
    # a port stream: the JAX decoder's profile check refuses it
    tc = ScanWavefrontCodec(CFG, CFG.geometry(), H, W, batch=1, lanes=L,
                            dtype=torch.float32,
                            device="cpu").prepare(model.ent)
    pfn = str(tmp_path / "port.bin")
    tc.write_files(tc.encode_planes(_planes(3)[:1]), [pfn])
    jc = JaxScan(JCFG, JCFG.geometry(), H, W, batch=1, lanes=L,
                 dtype=jnp.float32, window_mode="gather")
    with pytest.raises(ValueError, match="profile"):
        jc.decode_files([pfn])


def test_entry_points_default_to_the_card(model, tmp_path, monkeypatch):
    """Without ``device`` an entry point asks for the card; on a machine
    without one it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((1, 3, 64, 128), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scan_encode_images(model, [x], CFG.geometry(),
                           [str(tmp_path / "x.bin")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scan_decode_images(model, CFG.geometry(), [str(tmp_path / "x.bin")],
                           (64, 128))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScanWavefrontCodec(CFG, CFG.geometry(), H, W)


def test_port_imports_no_jax():
    """Every module of the port imports with jax and the JAX package
    unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pseudocylindrical_convolution_tpu'] = None\n"
        "import pseudocylindrical_convolution_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and\n"
        "       (k.startswith('jax') or 'convolution_tpu' in k)]\n"
        "assert not bad, bad\n"
        "import chip_smoke\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_surface(tmp_path, monkeypatch):
    """The scan-mode CLI: the bpp convention, .npy image I/O, and its
    refusals (bad arguments, a registry entry with no checkpoint)."""
    from pseudocylindrical_convolution_torch import cli
    assert cli.bits_per_pixel(65536) == 1.0          # 8 bits over 512x1024
    img = np.random.default_rng(0).integers(0, 256, (512, 1024, 3),
                                            dtype=np.uint8)
    np.save(tmp_path / "a.npy", img)
    x = cli.read_image(str(tmp_path / "a.npy"))
    assert x.shape == (1, 3, 512, 1024)
    cli.write_image(str(tmp_path / "b.npy"), x[0])
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"), img)
    for argv in (["--enc"], ["--enc", "--dec"], ["--dec", "--model-idx", "10"],
                 ["--enc", "--img-list", "a.npy", "--code-list"]):
        with pytest.raises(SystemExit):
            cli.main(argv)
    monkeypatch.setattr(cli, "model_spec", lambda idx, mse: (
        str(tmp_path / "missing.pkl"), 192))
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli.main(["--enc", "--img-list", str(tmp_path / "a.npy"),
                  "--code-list", str(tmp_path / "a.bin"), "--device", "cpu"])
