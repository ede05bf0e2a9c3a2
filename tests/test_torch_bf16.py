"""The port's bf16 transforms (``CMPNetConfig.transform_dtype="bfloat16"``)
and its ``Timer``, on the CPU, against the JAX package.

Against JAX's bf16 transforms on the same seeded weights and images
(tiny config): the port's convs return bf16 for bf16 operands, so each
conv output is rounded to bf16 once more than JAX's fp32 accumulations
(models/layers.py::Conv2d). Measured: encoder outputs in [0, 1] differ by
at most 9.3e-4 and reconstructions by at most 8.3e-3; held to atol 3e-3
and 2.5e-2. Latents are integers: 0 of 1024 differ in the measurement,
and a latent within bf16 noise of a quantizer midpoint may round either
way, so the test allows 1% and reports the count. The bf16 outputs must
also differ from the fp32 ones (the option takes effect).

Encode -> decode stays bit-exact in the window, fused, dense and
incremental paths with bf16 transforms: the entropy network, which makes
the CDF rows, stays fp32.
"""

import dataclasses
import inspect
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pseudocylindrical_convolution_tpu.models import transform as jtr

from pseudocylindrical_convolution_torch.codec import (
    api, incremental, pipeline, wavefront_scan)
from pseudocylindrical_convolution_torch.models.cmpnet import (
    cmpnet_decode_latents, cmpnet_encode_latents, with_transform_dtype)
from pseudocylindrical_convolution_torch.train import difficulty
from pseudocylindrical_convolution_torch.utils.checkpoint import load_model
from pseudocylindrical_convolution_torch.utils.timer import Timer

from torch_parity import (CFG, JCFG, jax_decode_latents, jax_encode_latents,
                          jax_params, numpy_tree)

BCFG = dataclasses.replace(CFG, transform_dtype="bfloat16")
JBCFG = dataclasses.replace(JCFG, transform_dtype="bfloat16")
GEOM, JGEOM = CFG.geometry(), JCFG.geometry()
HW = (64, 128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return load_model(numpy_tree(0), BCFG, device="cpu")


def test_config_names_the_dtype(model):
    assert CFG.tdtype is None and BCFG.tdtype is torch.bfloat16
    with pytest.raises(ValueError, match="transform_dtype"):
        dataclasses.replace(CFG, transform_dtype="float16").tdtype
    fp32 = with_transform_dtype(model, "float32")
    assert fp32.cfg.transform_dtype == "float32"
    assert fp32.encoder is model.encoder and fp32.ent is model.ent
    assert with_transform_dtype(model, "bfloat16") is model


def test_transforms_against_jax_bf16(model):
    params = jax_params(0)
    rng = np.random.default_rng(1)
    tiles = rng.uniform(size=(4, 3, 16, 128)).astype(np.float32)
    want = np.asarray(jax.jit(jtr.encoder_apply, static_argnums=(2, 3))(
        params["encoder"], jnp.asarray(tiles), JGEOM, jnp.bfloat16))
    with torch.no_grad():
        got = model.encoder(torch.as_tensor(tiles), GEOM,
                            torch.bfloat16).numpy()
        f32 = model.encoder(torch.as_tensor(tiles), GEOM).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-3)
    assert np.abs(got - f32).max() > 1e-4

    x = rng.uniform(size=(4, 3) + HW).astype(np.float32)
    jlat = np.asarray(jax_encode_latents(params, jnp.asarray(x), JBCFG,
                                         JGEOM))
    with torch.no_grad():
        lat = cmpnet_encode_latents(model, torch.as_tensor(x), GEOM).numpy()
        rec = cmpnet_decode_latents(model, torch.tensor(jlat).long(),
                                    GEOM).numpy()
    mismatches = int((lat != jlat).sum())
    print(f"bf16 latents differing from JAX: {mismatches} of {lat.size}")
    assert mismatches <= lat.size // 100
    jrec = np.asarray(jax_decode_latents(params, jnp.asarray(jlat), JBCFG,
                                         JGEOM))
    np.testing.assert_allclose(rec, jrec, rtol=0, atol=2.5e-2)


def _valid(planes):
    v = np.zeros(planes.shape, bool)
    h, w = planes.shape[-2:]
    for b, wl in enumerate(GEOM.hindex(h * GEOM.npart, w)):
        v[:, b, ..., :int(wl)] = True
    return v


@pytest.mark.parametrize("path", ["window", "fused", "dense", "incremental"])
def test_roundtrip_bit_exact(model, tmp_path, path):
    x = np.random.default_rng(7).uniform(size=(1, 3) + HW).astype(
        np.float32)
    fn = str(tmp_path / "c.bin")
    if path in ("window", "fused"):
        _, planes = wavefront_scan.scan_encode_images(
            model, [x], GEOM, [fn], lanes=8, device="cpu",
            return_planes=True)
        if path == "fused":
            h, w = planes.shape[-2:]
            wavefront_scan.get_scan_codec(
                BCFG, GEOM, h, w, 1, 8, device="cpu",
                window_mode="fused").prepare(model.ent).encode_files(
                    planes, [fn])
        rec, dplanes = wavefront_scan.scan_decode_images(
            model, GEOM, [fn], HW, device="cpu", return_planes=True)
    else:
        enc, dec = ((pipeline.encode_images, pipeline.decode_image)
                    if path == "dense" else
                    (incremental.incr_encode_images,
                     incremental.incr_decode_images))
        _, planes = enc(model, [x], GEOM, [fn], device="cpu",
                        return_planes=True)
        rec, dplanes = dec(model, GEOM, [fn], HW, device="cpu",
                           return_planes=True)
    valid = _valid(planes)
    assert (dplanes[valid] == planes[valid]).all()
    with torch.no_grad():
        want = cmpnet_decode_latents(model, torch.as_tensor(planes).reshape(
            -1, *planes.shape[2:]), GEOM)
    assert torch.equal(rec, want)


def test_api_takes_the_transform_dtype(tmp_path):
    fp32 = load_model(numpy_tree(0), CFG, device="cpu")
    enc = api.PseudoEncoder(fp32, mode="dense", device="cpu",
                            transform_dtype="bfloat16")
    dec = api.PseudoDecoder(fp32, device="cpu", transform_dtype="bfloat16")
    assert enc.model.cfg.transform_dtype == "bfloat16"
    assert dec.model.cfg.transform_dtype == "bfloat16"
    assert fp32.cfg.transform_dtype == "float32"
    x = np.random.default_rng(8).uniform(size=(1, 3) + HW).astype(
        np.float32)
    fn = str(tmp_path / "c.bin")
    assert enc(x, fn) == os.path.getsize(fn)
    rec = dec(fn)
    bmodel = with_transform_dtype(fp32, "bfloat16")
    _, planes = pipeline.encode_images(bmodel, [x], GEOM,
                                       [str(tmp_path / "d.bin")],
                                       device="cpu", return_planes=True)
    with torch.no_grad():
        want = cmpnet_decode_latents(bmodel, torch.as_tensor(
            planes).reshape(-1, *planes.shape[2:]), GEOM)
    np.testing.assert_array_equal(rec, want.numpy())


def test_model_scores_default_to_bf16(monkeypatch, tmp_path):
    assert inspect.signature(difficulty.model_scores).parameters[
        "transform_dtype"].default == "bfloat16"
    seen = []

    def fake_load(path, cfg, device):
        seen.append(cfg.transform_dtype)
        return load_model(numpy_tree(0), dataclasses.replace(
            CFG, transform_dtype=cfg.transform_dtype), device)

    monkeypatch.setattr("pseudocylindrical_convolution_torch.utils."
                        "checkpoint.load_model", fake_load)
    img = np.random.default_rng(9).integers(0, 256, HW + (3,),
                                            dtype=np.uint8)
    np.save(tmp_path / "a.npy", img)
    scores = difficulty.model_scores(["a.npy"], str(tmp_path), "m.pkl", 8,
                                     device="cpu")
    assert seen == ["bfloat16"]
    assert list(scores) == ["a.png"] and scores["a.png"] > 0


def test_timer(tmp_path):
    t = Timer(enabled=True)
    x = torch.ones(4)
    for _ in range(2):
        with t.time("add", sync=x):
            x = x + 1
    with t.time("plain"):
        pass
    assert len(t.records["add"]) == 2 and len(t.records["plain"]) == 1
    assert all(v >= 0 for v in t.records["add"])
    lines = t.summary().splitlines()
    assert lines[0].startswith("add: n=2 mean=") and lines[0].endswith("ms")
    off = Timer()
    with off.time("add", sync=x):
        pass
    assert off.records == {}
    with t.profile(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert os.listdir(tmp_path / "trace")
