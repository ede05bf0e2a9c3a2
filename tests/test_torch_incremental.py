"""The port's incremental codec on the CPU, against its own dense network
and the JAX package.

  * The teacher-forced frontier parameters equal the port's dense raw
    maps at every step's cells (fp32 allclose, rtol 1e-4, atol 1e-5), and
    the CDF rows equal the dense rows but for counted rows, each entry
    within 1 (the two are different programs; 5 of 216 rows at each
    seed), as JAX's test_wavefront_params_match_dense holds its own.
  * The CDF rows against the JAX incremental codec's, counted the same
    way (8 of 432 rows).
  * The roundtrip is bit-exact (both directions run one step function).
  * The image path: latents equal the JAX package's, and the
    reconstruction is allclose to the JAX decoder's.
  * Streams: MODE_INCR with FLAG2_TORCH; a JAX incremental stream is
    refused by name. Entry points run on the card unless told otherwise.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudocylindrical_convolution_tpu.codec import container as jcontainer
from pseudocylindrical_convolution_tpu.codec import incremental as jinc

from pseudocylindrical_convolution_torch.codec import container
from pseudocylindrical_convolution_torch.codec import pipeline as pl
from pseudocylindrical_convolution_torch.codec.incremental import (
    WavefrontCodec, get_incremental_codec, incr_decode_images,
    incr_encode_images)
from pseudocylindrical_convolution_torch.models.entropy import fused_weights
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
    return load_model(numpy_tree(5), CFG, device="cpu")


@pytest.fixture(scope="module")
def codec(model):
    return WavefrontCodec(CFG, GEOM, H, W, device="cpu").prepare(model.ent)


def _plane(seed):
    """Symbols (npart, G, h, w), zero outside the valid region."""
    p = np.random.default_rng(seed).integers(0, 8, (CFG.npart, CFG.ngroup,
                                                    H, W))
    for b, wl in enumerate(GEOM.hindex(H * CFG.npart, W)):
        p[b, :, :, int(wl):] = 0
    return p


@pytest.mark.parametrize("seed", [0, 1])
def test_frontier_params_match_dense(model, codec, seed):
    plane = _plane(seed)
    syms = torch.as_tensor(plane.reshape(-1)[codec.plane_idx])
    raw_steps = []
    rows = codec._run(teacher=syms, raw_out=raw_steps).numpy()
    got = torch.cat(raw_steps, dim=1)                    # (3, nsym, ng)
    sched = pl._Schedule(GEOM, H, W, CFG.ngroup, "cpu")
    layers = fused_weights(model.ent, CFG.ngroup)
    dense = pl._raw_rows(layers, torch.as_tensor(plane.astype(np.float32)
                                                 - 3.5), GEOM)
    want = dense[:, sched.flat_pad[:sched.flat.shape[0]]]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    dense_rows = pl._table_body(layers, torch.as_tensor(
        plane[None].astype(np.float32) - 3.5), GEOM, sched)[0].numpy()
    assert rows.shape == (sched.flat.shape[0], 7)
    differ = int((rows != dense_rows[:, 1:8]).any(axis=1).sum())
    assert differ <= rows.shape[0] * 5 // 100, differ
    assert np.abs(rows.astype(np.int64) - dense_rows[:, 1:8]).max() <= 1


def test_rows_against_jax(codec):
    """The teacher-forced CDF rows equal the JAX incremental codec's on
    the same planes but for counted rows, each entry within 1: at these
    seeds 8 of 432 rows differ (at most 5% allowed)."""
    jc = jinc.WavefrontCodec(JCFG, JCFG.geometry(), H, W)
    jc.prepare(jax_params(5)["ent"])
    differ = total = 0
    for seed in (0, 1):
        plane = _plane(seed)
        rows = codec._run(teacher=torch.as_tensor(
            plane.reshape(-1)[codec.plane_idx])).numpy()
        _, steps = jc._run(None, teacher_plane=plane.astype(np.float32))
        want = np.concatenate([np.asarray(tb)[jc.grid_idx[
            jc.offsets[z]:jc.offsets[z] + int(jc.counts[z])]]
            for z, tb in steps]).astype(np.int64)
        assert rows.shape == want.shape
        differ += int((rows != want).any(axis=1).sum())
        total += rows.shape[0]
        assert np.abs(rows - want).max() <= 1
    assert differ <= total * 5 // 100, differ


@pytest.mark.parametrize("seed", [2, 3])
def test_roundtrip_bit_exact(codec, tmp_path, seed):
    plane = _plane(seed)
    fn = str(tmp_path / "wf.bin")
    size = codec.encode(plane, fn)
    assert size == os.path.getsize(fn)
    np.testing.assert_array_equal(codec.decode(fn), plane)
    hdr = container.read_stream(fn)
    assert (hdr["mode"], hdr["flags"], hdr["flags2"]) == (
        container.MODE_INCR, 0, container.FLAG2_TORCH)


def test_image_path_against_jax(model, tmp_path):
    rng = np.random.default_rng(8)
    xs = [rng.uniform(size=(1, 3) + HW).astype(np.float32) for _ in "ab"]
    fns = [str(tmp_path / f"{k}.bin") for k in "ab"]
    sizes, planes = incr_encode_images(model, xs, GEOM, fns, device="cpu",
                                       return_planes=True)
    assert sizes == [os.path.getsize(f) for f in fns]
    rec, dplanes = incr_decode_images(model, GEOM, fns, HW, device="cpu",
                                      return_planes=True)
    np.testing.assert_array_equal(dplanes, planes)
    params = jax_params(5)
    hcode = np.asarray(jax_encode_latents(params, jnp.asarray(xs[1]), JCFG,
                                          JCFG.geometry()))
    np.testing.assert_array_equal(planes[1], hcode.reshape(planes[1].shape))
    want = np.asarray(jax_decode_latents(params, jnp.asarray(hcode), JCFG,
                                         JCFG.geometry()))
    np.testing.assert_allclose(rec[1:].numpy(), want, rtol=1e-4, atol=1e-5)
    assert get_incremental_codec(CFG, GEOM, H, W, "cpu") is \
        get_incremental_codec(CFG, GEOM, H, W, "cpu")


def test_jax_incremental_stream_refused(tmp_path):
    jc = jinc.WavefrontCodec(JCFG, JCFG.geometry(), H, W)
    jc.prepare(jax_params(5)["ent"])
    jfn = str(tmp_path / "jax.bin")
    jc.encode(_plane(4).astype(np.float32), jfn)
    assert jcontainer.read_stream(jfn)["mode"] == jcontainer.MODE_INCR
    with pytest.raises(ValueError, match="JAX package"):
        container.read_stream(jfn)


def test_entry_points_default_to_the_card(model, tmp_path, monkeypatch):
    """Without ``device`` the dense and incremental entry points ask for
    the card; on a machine without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((1, 3) + HW, np.float32)
    fn = str(tmp_path / "x.bin")
    for call in (lambda: incr_encode_images(model, [x], GEOM, [fn]),
                 lambda: incr_decode_images(model, GEOM, [fn], HW),
                 lambda: WavefrontCodec(CFG, GEOM, H, W),
                 lambda: pl.encode_images(model, [x], GEOM, [fn]),
                 lambda: pl.decode_image(model, GEOM, fn, HW)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
