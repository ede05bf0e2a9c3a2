"""The port's codec surface on the CPU: the --test metrics, codec/api.py
and the CLI in every mode, against the JAX package.

  * ``ws_psnr``, ``ssim`` and ``multi_project`` (forward) on seeded
    images, allclose to the JAX ones: WS-MSE and WS-PSNR at rtol 1e-4
    and SSIM at rtol 1e-5 (fp32 sums in another order; measured 1.5e-5,
    2.5e-6 and 6e-7), the projection at rtol 1e-6 (the same 4-tap sum in
    the same order).
  * ``PseudoEncoder``/``PseudoDecoder`` roundtrip in all three modes, the
    decoder picking the mode from the header (after tests/test_api.py).
  * The CLI's --enc, --dec and --test in all three modes on .npy files
    through a tiny registry; the three modes decode the same image to
    the same output (one encoder made the latents); list files; --test
    numbers against the JAX CLI's on the same image.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudocylindrical_convolution_tpu import cli as jcli
from pseudocylindrical_convolution_tpu.ops import projects as jproj
from pseudocylindrical_convolution_tpu.ops import ssim as jssim
from pseudocylindrical_convolution_tpu.ops import wspsnr as jws
from pseudocylindrical_convolution_tpu.utils.checkpoint import save_params

from pseudocylindrical_convolution_torch import cli
from pseudocylindrical_convolution_torch.codec import container
from pseudocylindrical_convolution_torch.codec.api import (
    MODES, PseudoDecoder, PseudoEncoder)
from pseudocylindrical_convolution_torch.ops import projects as tproj
from pseudocylindrical_convolution_torch.ops import ssim as tssim
from pseudocylindrical_convolution_torch.ops import wspsnr as tws
from pseudocylindrical_convolution_torch.utils.checkpoint import load_model

from torch_parity import CFG, JCFG, jax_params, numpy_tree

HW = (64, 128)
MODE_OF = {"scan": container.MODE_SCAN, "dense": container.MODE_DENSE,
           "incremental": container.MODE_INCR}


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
    return load_model(numpy_tree(6), CFG, device="cpu")


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape).astype(np.float32), 0, 1)
    return a, b


def test_ws_psnr_against_jax():
    np.testing.assert_array_equal(tws.erp_row_weights(64),
                                  jws.erp_row_weights(64))
    x, y = _pair(0, (2, 3) + HW)
    for fn in ("ws_mse", "ws_psnr"):
        want = float(getattr(jws, fn)(jnp.asarray(x), jnp.asarray(y)))
        got = float(getattr(tws, fn)(torch.as_tensor(x), torch.as_tensor(y)))
        np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("shape", [(2, 3, 32, 40), (14, 3, 171, 256)])
def test_ssim_against_jax(shape):
    a, b = _pair(1, shape)
    for avg in (True, False):
        want = np.asarray(jssim.ssim(jnp.asarray(a), jnp.asarray(b),
                                     size_average=avg))
        got = tssim.ssim(torch.as_tensor(a), torch.as_tensor(b),
                         size_average=avg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(tssim.ssim(torch.as_tensor(a), torch.as_tensor(a))) > 0.999


def test_multi_project_against_jax():
    x, _ = _pair(2, (2, 3) + HW)
    for args in ((171, 256, 0.5), (17, 25, 0.5)):
        want = np.asarray(jproj.multi_project(jnp.asarray(x), *args))
        got = tproj.multi_project(torch.as_tensor(x), *args).numpy()
        assert got.shape == want.shape == (28, 3) + args[:2]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", MODES)
def test_api_roundtrip(model, tmp_path, mode):
    enc = PseudoEncoder(model, mode=mode, batch=1, lanes=8, device="cpu")
    dec = PseudoDecoder(model, device="cpu")
    x = np.random.default_rng(3).uniform(size=(1, 3) + HW).astype(
        np.float32)
    fn = str(tmp_path / "c.bin")
    size = enc(x, fn)
    assert size == os.path.getsize(fn) > 0
    assert container.read_stream(fn)["mode"] == MODE_OF[mode]
    rec = dec(fn)
    assert rec.shape == (1, 3) + HW and np.isfinite(rec).all()
    np.testing.assert_array_equal(rec, dec(fn))
    with pytest.raises(ValueError, match="not one of"):
        PseudoEncoder(model, mode="slab")


@pytest.fixture
def registry(model, tmp_path, monkeypatch):
    """The port's CLI over the tiny model and 64x128 images, and one .npy
    image."""
    monkeypatch.setattr(cli, "IMAGE_HW", HW)
    monkeypatch.setattr(cli, "_setup", lambda idx, mse, device: model)
    img = np.random.default_rng(4).integers(0, 256, HW + (3,),
                                            dtype=np.uint8)
    fn = str(tmp_path / "img.npy")
    np.save(fn, img)
    return fn


def _average(text):
    """The numbers of the --test 'Average Performance' line."""
    line = text.split("Average Performance")[1]
    return [float(v) for v in re.findall(r":(-?[0-9.]+)", line)]


@pytest.mark.parametrize("mode", MODES)
def test_cli_enc_dec_test(registry, tmp_path, capsys, mode):
    code = str(tmp_path / f"{mode}.bin")
    out = str(tmp_path / f"{mode}_dec.npy")
    dev = ["--device", "cpu", "--model-idx", "0"]
    cli.main(["--enc", "--img-list", registry, "--code-list", code,
              "--mode", mode] + dev)
    assert container.read_stream(code)["mode"] == MODE_OF[mode]
    cli.main(["--dec", "--code-list", code, "--out-list", out] + dev)
    dec = np.load(out)
    assert dec.shape == HW + (3,) and dec.dtype == np.uint8
    avg = cli.main(["--test", "--code-list", code, "--img-list", registry]
                   + dev)
    text = capsys.readouterr().out
    assert "Bitrate" in text and "WS-PSNR" in text
    assert avg["bpp"] == cli.bits_per_pixel(os.path.getsize(code))
    np.testing.assert_allclose(_average(text), [
        avg["bpp"], avg["psnr_db"], avg["ssim"], avg["ws_psnr_db"]],
        atol=6e-3)


def test_cli_list_files_and_modes_agree(registry, tmp_path):
    """--img-file/--code-file/--out-file; the three modes' streams of one
    image decode to the same output."""
    dev = ["--device", "cpu", "--model-idx", "0"]
    outs = []
    for mode in MODES:
        codes = [str(tmp_path / f"{mode}_{k}.bin") for k in range(2)]
        outs.append([str(tmp_path / f"{mode}_{k}.npy") for k in range(2)])
        for name, lst in (("img", [registry] * 2), ("code", codes),
                          ("out", outs[-1])):
            with open(tmp_path / f"{name}.txt", "w") as f:
                f.write("\n".join(lst) + "\n")
        cli.main(["--enc", "--img-file", str(tmp_path / "img.txt"),
                  "--code-file", str(tmp_path / "code.txt"), "--mode",
                  mode] + dev)
        cli.main(["--dec", "--code-file", str(tmp_path / "code.txt"),
                  "--out-file", str(tmp_path / "out.txt")] + dev)
    ref = np.load(outs[0][0])
    for out in outs:
        for fn in out:
            np.testing.assert_array_equal(np.load(fn), ref)
    with pytest.raises(SystemExit):
        cli.main(["--test", "--dec", "--code-list", "a.bin"] + dev)


def test_cli_test_against_jax(registry, tmp_path, monkeypatch, capsys):
    """--test numbers of a dense stream against the JAX CLI's on its own
    dense stream of the same image: the latents are equal and the
    reconstructions allclose, so the printed averages agree to their
    printed digits (bpp to 1e-3: the streams may differ by a few bytes)."""
    mdir = tmp_path / "mse"
    mdir.mkdir()
    save_params(jax_params(6), str(mdir / "1_8.pkl"))
    monkeypatch.setattr(jcli, "MODEL_MSE_LIST", ["1_8"])
    monkeypatch.setattr(jcli, "MSE_CHANNEL_LIST", [8])
    monkeypatch.setattr(jcli, "MSE_MODEL_DIR", str(mdir))
    monkeypatch.setattr(jcli, "IMAGE_HW", HW)
    monkeypatch.setattr(jcli, "_setup", lambda idx, mse, device_id=0: (
        JCFG, JCFG.geometry(), jcli.load_codec_params(str(mdir), "1_8")))
    jcode, tcode = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jcli.main(["--enc", "--img-list", registry, "--code-list", jcode,
               "--mode", "dense"])
    jcli.main(["--test", "--code-list", jcode, "--img-list", registry])
    want = _average(capsys.readouterr().out)
    dev = ["--device", "cpu"]
    cli.main(["--enc", "--img-list", registry, "--code-list", tcode,
              "--mode", "dense"] + dev)
    got = cli.main(["--test", "--code-list", tcode, "--img-list", registry]
                   + dev)
    for key, k, tol in (("bpp", 0, 1e-3), ("psnr_db", 1, 6e-3),
                        ("ssim", 2, 6e-5), ("ws_psnr_db", 3, 6e-3)):
        assert abs(got[key] - want[k]) <= tol, (key, got[key], want[k])
