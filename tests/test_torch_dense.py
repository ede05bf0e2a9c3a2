"""The port's entropy model and dense codec on the CPU, against the JAX
package.

  * ``entropy_net_raw`` equals the JAX one at fp32 allclose (rtol 1e-4,
    atol 1e-5, as in test_torch_models.py), and the fused net equals the
    port's own unfused ``entropy_subnet_raw`` (rtol = atol = 2e-5, the
    JAX package's own bound in test_entropy_fused.py).
  * Dense CDF rows against JAX ``_table_program`` on the same plane:
    equal but for counted rows, each entry within 1 (torch's and XLA's
    fp32 conv sums and erf differ in the last bits; see
    test_torch_ops.py::test_gmm_cdf_table_rows).
  * The claim the dense decode rests on, bit for bit: the network on a
    partial plane gives step z's cells the bits of the full plane.
  * The port's dense encode -> decode is bit-exact (the SKILL.md oracle),
    in lockstep over two streams, and its reconstruction is allclose to
    the JAX decoder's on the same latents.
  * Streams: MODE_DENSE with FLAG2_TORCH; a JAX dense stream is refused by
    name; a stream of another mode is refused by the dense decoder.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudocylindrical_convolution_tpu.codec import container as jcontainer
from pseudocylindrical_convolution_tpu.codec import pipeline as jpl
from pseudocylindrical_convolution_tpu.models import entropy as jent

from pseudocylindrical_convolution_torch.codec import container
from pseudocylindrical_convolution_torch.codec import pipeline as pl
from pseudocylindrical_convolution_torch.codec.wavefront_scan import (
    scan_encode_images)
from pseudocylindrical_convolution_torch.models import entropy as tent
from pseudocylindrical_convolution_torch.ops.fill import pseudo_fill
from pseudocylindrical_convolution_torch.utils.checkpoint import load_model

from torch_parity import (CFG, JCFG, jax_decode_latents, jax_encode_latents,
                          jax_params, numpy_tree)

H, W = 2, 16
HW = (64, 128)
GEOM = CFG.geometry()


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
    return load_model(numpy_tree(4), CFG, device="cpu")


def _symbols(seed, n=1):
    """Biased symbols (n*npart, G, h, w), zero outside the valid region."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 8, (n * CFG.npart, CFG.ngroup, H, W))
    x = torch.as_tensor(s.astype(np.float32) - 3.5)
    return pseudo_fill(x, GEOM).numpy()


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1)])
def test_entropy_net_raw_against_jax(model, n, seed):
    x = _symbols(seed, n)
    want = jent.entropy_net_raw(jax_params(4)["ent"], jnp.asarray(x),
                                JCFG.geometry(), CFG.ngroup)
    got = tent.entropy_net_raw(model.ent, torch.as_tensor(x), GEOM,
                               CFG.ngroup)
    for k in ("weight", "delta", "mean"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5)


def test_fused_equals_per_subnet(model):
    x = torch.as_tensor(_symbols(2, 2))
    fused = tent.entropy_net_raw(model.ent, x, GEOM, CFG.ngroup)
    for k, sub in (("weight", "weight_net"), ("delta", "delta_net"),
                   ("mean", "mean_net")):
        sep = tent.entropy_subnet_raw(getattr(model.ent, sub), x, GEOM,
                                      CFG.ngroup)
        np.testing.assert_allclose(fused[k].numpy(), sep.numpy(),
                                   rtol=2e-5, atol=2e-5)


def test_dense_rows_against_jax(model):
    """Dense CDF rows equal JAX ``_table_program``'s on the same plane but
    for counted rows (at most 5%; 6 of 216 at this seed), each entry
    within 1."""
    plane = _symbols(3).reshape(1, CFG.npart, CFG.ngroup, H, W)
    want = np.asarray(jpl._table_program(jax_params(4)["ent"],
                                         jnp.asarray(plane), JCFG,
                                         JCFG.geometry()))
    sched = pl._Schedule(GEOM, H, W, CFG.ngroup, "cpu")
    got = pl._table_body(tent.fused_weights(model.ent, CFG.ngroup),
                         torch.as_tensor(plane), GEOM, sched).numpy()
    assert got.shape == want.shape == (1, sched.flat.shape[0], 9)
    differ = int((got != want).any(axis=2).sum())
    assert differ <= got.shape[1] * 5 // 100, differ
    assert np.abs(got.astype(np.int64) - want).max() <= 1


def test_partial_plane_gives_the_full_plane_bits(model):
    """At every step, the raw parameters of the step's cells from the
    partial plane (earlier steps' symbols, zeros elsewhere) equal those
    from the full plane bit for bit, and so do the CDF rows."""
    plane = torch.as_tensor(_symbols(5).reshape(CFG.npart, CFG.ngroup, H,
                                                W))
    layers = tent.fused_weights(model.ent, CFG.ngroup)
    sched = pl._Schedule(GEOM, H, W, CFG.ngroup, "cpu")
    full = pl._raw_rows(layers, plane, GEOM)
    partial = torch.zeros_like(plane)
    for z in range(sched.nsteps):
        o, n = int(sched.offsets[z]), int(sched.counts[z])
        pos = sched.flat_pad[o:o + n]
        part = pl._raw_rows(layers, partial, GEOM)
        assert torch.equal(part[:, pos].view(torch.int32),
                           full[:, pos].view(torch.int32)), z
        assert torch.equal(pl._step_rows(part, sched, z)[:n],
                           pl._step_rows(full, sched, z)[:n]), z
        partial.view(-1)[pos] = plane.view(-1)[pos]


def test_dense_roundtrip_bit_exact(model, tmp_path):
    """Image -> latents -> two dense streams -> latents (lockstep) ->
    images; the reconstruction is allclose to the JAX decoder's."""
    rng = np.random.default_rng(6)
    xs = [rng.uniform(size=(1, 3) + HW).astype(np.float32) for _ in "ab"]
    fns = [str(tmp_path / f"{k}.bin") for k in "ab"]
    sizes, planes = pl.encode_images(model, xs, GEOM, fns, device="cpu",
                                     return_planes=True)
    assert sizes == [os.path.getsize(f) for f in fns]
    rec, dplanes = pl.decode_image(model, GEOM, fns, HW, device="cpu",
                                   return_planes=True)
    np.testing.assert_array_equal(dplanes, planes)
    np.testing.assert_array_equal(
        pl.decode_latents(model, GEOM, H, W, fns[1], device="cpu"),
        planes[1])
    params = jax_params(4)
    hcode = np.asarray(jax_encode_latents(params, jnp.asarray(xs[0]), JCFG,
                                          JCFG.geometry()))
    np.testing.assert_array_equal(planes[0], hcode.reshape(planes[0].shape))
    want = np.asarray(jax_decode_latents(params, jnp.asarray(hcode), JCFG,
                                         JCFG.geometry()))
    np.testing.assert_allclose(rec[:1].numpy(), want, rtol=1e-4, atol=1e-5)
    hdr = container.read_stream(fns[0])
    assert (hdr["mode"], hdr["flags"], hdr["flags2"]) == (
        container.MODE_DENSE, 0, container.FLAG2_TORCH)
    # a batch goes through B=1 programs: the same bytes as one at a time
    bfns = [str(tmp_path / f"batch_{k}.bin") for k in "ab"]
    assert pl.encode_image(model, np.concatenate(xs), GEOM, bfns,
                           device="cpu") == sizes
    for f, g in zip(fns, bfns):
        assert open(f, "rb").read() == open(g, "rb").read()
    # the test helper agrees with the encoder
    syms, tables, hc = pl._encode_tables(model, xs[0], GEOM, device="cpu")
    assert syms.shape[0] == tables.shape[0] and tables.shape[1] == 9
    np.testing.assert_array_equal(hc[0].numpy(), planes[0])


def test_dense_streams_refused(model, tmp_path):
    """The port refuses a JAX dense stream by name, and the dense decoder
    refuses a port stream of another mode."""
    jfn = str(tmp_path / "jax.bin")
    x = np.random.default_rng(7).uniform(size=(1, 3) + HW).astype(
        np.float32)
    jpl.encode_image(jax_params(4), jnp.asarray(x), JCFG, JCFG.geometry(),
                     jfn)
    assert jcontainer.read_stream(jfn)["mode"] == jcontainer.MODE_DENSE
    with pytest.raises(ValueError, match="JAX package"):
        container.read_stream(jfn)
    sfn = str(tmp_path / "scan.bin")
    scan_encode_images(model, [x], GEOM, [sfn], device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        pl.decode_image(model, GEOM, sfn, HW, device="cpu")
    # a dense header with a profile bit it never carries
    pfn = str(tmp_path / "bf16.bin")
    container.write_stream(pfn, container.MODE_DENSE, CFG.npart,
                           CFG.valid_dim, H, W, b"\0" * 8,
                           flags=container.FLAG_BF16)
    with pytest.raises(ValueError, match="dense mode"):
        pl.decode_image(model, GEOM, pfn, HW, device="cpu")
