"""Codec CLI (the reference's public surface, pseudo_codec.py:310-356, as
the JAX package's ``cli.py`` has it).

  python -m pseudocylindrical_convolution_torch.cli --enc \
      --img-list a.png --code-list a.bin --model-idx 9 [--mode dense]
  python -m pseudocylindrical_convolution_torch.cli --dec \
      --code-list a.bin --out-list a_dec.png --model-idx 9
  python -m pseudocylindrical_convolution_torch.cli --test \
      --code-list a.bin --img-list a.png --model-idx 9

A registry entry's checkpoint is ``{prefix}.pkl`` under demo/{mse,ssim},
or the reference's split ``{prefix}_{encoder,decoder,ent}.pt`` files,
converted at load.
``--img-file``/``--code-file``/``--out-file`` name list files, one path
per line, in place of the lists. Images are 8-bit BGR files read with
OpenCV (as the reference does), or ``.npy`` arrays of shape (H, W, 3);
PNG needs ``cv2`` installed. ``--mode`` picks the encoder: scan (the
default), dense or incremental; ``--dec`` and ``--test`` take the mode
and the image size from each stream's header. Streams are the port's
own containers. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

MODEL_SSIM_LIST = ["1_56", "2_56", "3_56", "4_56", "5_112", "6_112", "7_112",
                   "8_192", "9_192"]
SSIM_CHANNEL_LIST = [56, 56, 56, 56, 112, 112, 112, 192, 192]
MODEL_MSE_LIST = ["1_56", "2_56", "3_56", "4_112", "5_112", "6_112", "7_112",
                  "8_192", "9_192", "10_192"]
MSE_CHANNEL_LIST = [56, 56, 56, 112, 112, 112, 112, 192, 192, 192]
MSE_MODEL_DIR = "./demo/mse"
SSIM_MODEL_DIR = "./demo/ssim"
IMAGE_HW = (512, 1024)


def psnr_f(mse: float) -> float:
    return 10 * math.log10(1.0 / mse)


def model_spec(model_idx: int, mse: bool):
    """(checkpoint path, valid_dim) of a registry entry."""
    prefix = (MODEL_MSE_LIST if mse else MODEL_SSIM_LIST)[model_idx]
    vd = (MSE_CHANNEL_LIST if mse else SSIM_CHANNEL_LIST)[model_idx]
    mdir = MSE_MODEL_DIR if mse else SSIM_MODEL_DIR
    return os.path.join(mdir, f"{prefix}.pkl"), vd


def bits_per_pixel(nbytes: int, hw=IMAGE_HW) -> float:
    """The reference's bpp convention: bytes * 8 over H*W pixels."""
    return nbytes * 8 / float(hw[0] * hw[1])


def read_image(path: str, hw=None) -> np.ndarray:
    """(1, 3, H, W) float32 in [0, 1], BGR like the reference; resized to
    ``hw`` (default IMAGE_HW) if it is not that size."""
    hw = IMAGE_HW if hw is None else hw
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        import cv2
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
    if img.shape[:2] != tuple(hw):
        import cv2
        img = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    return img.transpose(2, 0, 1)[None].astype(np.float32) / 255.0


def write_image(path: str, rec) -> None:
    """Reconstruction (3, H, W) in [0, 1] -> 8-bit file (PNG via cv2, or
    .npy): clip, scale by 255 and truncate, as the reference writes."""
    img = (np.clip(np.asarray(rec), 0.0, 1.0) * 255.0).astype(np.uint8)
    img = img.transpose(1, 2, 0)
    if path.endswith(".npy"):
        np.save(path, img)
    else:
        import cv2
        cv2.imwrite(path, img)


def load_codec_params(model_dir: str, prefix: str, template=None) -> dict:
    """The parameter tree of ``{prefix}.pkl``, else the reference's split
    ``{prefix}_{encoder,decoder,ent}.pt`` files converted (JAX
    ``cli.py:75-100``). ``template`` (a parameter tree of the model) makes
    the conversion strict both ways, like the reference's
    ``load_state_dict`` (pseudo_codec.py:227)."""
    from pseudocylindrical_convolution_torch.utils.checkpoint import (
        load_param_tree, load_torch_state_dict, reference_to_params)
    pkl = os.path.join(model_dir, f"{prefix}.pkl")
    if os.path.exists(pkl):
        return load_param_tree(pkl)
    sds = {}
    for part in ("encoder", "decoder", "ent"):
        path = os.path.join(model_dir, f"{prefix}_{part}.pt")
        sds[part] = (load_torch_state_dict(path) if os.path.exists(path)
                     else None)
    if not any(sds.values()):
        raise FileNotFoundError(
            f"no checkpoint {pkl} or {prefix}_*.pt under {model_dir}")
    return reference_to_params(sds["encoder"], sds["decoder"], sds["ent"],
                               template=template)


def _setup(model_idx: int, mse: bool, device: str):
    """The registry entry's model (its ``.pkl``, else the reference's
    split ``.pt`` files), loaded onto ``device``."""
    from pseudocylindrical_convolution_torch.models.cmpnet import (
        CMPNet, CMPNetConfig)
    from pseudocylindrical_convolution_torch.utils.checkpoint import (
        load_model, params_to_tree)
    path, vd = model_spec(model_idx, mse)
    cfg = CMPNetConfig(valid_dim=vd)
    mdir, name = os.path.split(path)
    prefix = name[: -len(".pkl")]
    template = None
    if not os.path.exists(path):
        if not any(os.path.exists(os.path.join(mdir, f"{prefix}_{p}.pt"))
                   for p in ("encoder", "decoder", "ent")):
            raise SystemExit(f"--model-idx {model_idx}: no checkpoint "
                             f"{path} nor the reference's {prefix}_"
                             f"{{encoder,decoder,ent}}.pt")
        template = params_to_tree(CMPNet(cfg))
    return load_model(load_codec_params(mdir, prefix, template), cfg,
                      device)


def read_list(fname: str) -> list:
    with open(fname) as f:
        return [ln.rstrip("\n") for ln in f.readlines()]


def encoding(img_list, code_list, model_idx=0, mse=True, device="cuda",
             mode="scan", batch=1, lanes=None):
    from pseudocylindrical_convolution_torch.codec.api import encode_any
    model = _setup(model_idx, mse, device)
    images = [read_image(fn) for fn in img_list]
    sizes = encode_any(model, images, code_list, mode, batch, lanes, device)
    for fn, size in zip(img_list, sizes):
        print(f"Encoding {fn}, bitrate: {bits_per_pixel(size):.3f}bpp")


def decoding(code_list, out_list, model_idx=0, mse=True, device="cuda"):
    from pseudocylindrical_convolution_torch.codec.api import decode_any
    model = _setup(model_idx, mse, device)
    recs = decode_any(model, list(code_list), device).cpu().numpy()
    for rec, fc, fo in zip(recs, code_list, out_list):
        write_image(fo, rec)
        print(f"Decoding {fc}, output to {fo}")


def decoding_and_test(code_list, img_list, model_idx=0, mse=True,
                      device="cuda") -> dict:
    """Decode, then print each stream's bpp, viewport PSNR and SSIM (14
    viewports of 171x256, fov 0.5) and WS-PSNR against its source image,
    and their averages; returns the averages."""
    import torch
    from pseudocylindrical_convolution_torch.codec.api import decode_any
    from pseudocylindrical_convolution_torch.ops.projects import (
        multi_project)
    from pseudocylindrical_convolution_torch.ops.ssim import ssim
    from pseudocylindrical_convolution_torch.ops.wspsnr import ws_psnr
    model = _setup(model_idx, mse, device)
    recs = decode_any(model, list(code_list), device)
    rows = []
    for b, (fc, fn) in enumerate(zip(code_list, img_list)):
        rec = recs[b:b + 1]
        x = torch.as_tensor(read_image(fn), device=rec.device)
        px = multi_project(x, 171, 256, 0.5)
        py = multi_project(rec, 171, 256, 0.5)
        pr = psnr_f(float(torch.mean((px - py) ** 2)))
        vssim = float(ssim(px, py))
        wsp = float(ws_psnr(x, rec))
        rt = bits_per_pixel(os.path.getsize(fc))
        rows.append((rt, pr, vssim, wsp))
        print(f"Decoding {fc}, compare it to {fn} \n "
              f"Bitrate:{rt:.3f}bpp, PSNR:{pr:.2f}dB, SSIM:{vssim:.4f}, "
              f"WS-PSNR:{wsp:.2f}dB")
    rt, pr, vssim, wsp = np.mean(rows, axis=0)
    print("-" * 53 + "\nAverage Performance\n" + "-" * 53)
    print(f"Bitrate:{rt:.3f}bpp, PSNR:{pr:.2f}dB, SSIM:{vssim:.4f}, "
          f"WS-PSNR:{wsp:.2f}dB")
    return {"bpp": float(rt), "psnr_db": float(pr), "ssim": float(vssim),
            "ws_psnr_db": float(wsp)}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Pseudocylindrical convolution 360 image compression "
                    "(PyTorch/CUDA)")
    parser.add_argument("--img-list", nargs="*")
    parser.add_argument("--code-list", nargs="*")
    parser.add_argument("--out-list", nargs="*")
    parser.add_argument("--img-file")
    parser.add_argument("--code-file")
    parser.add_argument("--out-file")
    parser.add_argument("--model-idx", type=int, default=0)
    parser.add_argument("--enc", action="store_true")
    parser.add_argument("--dec", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--ssim", action="store_true")
    parser.add_argument("--mode", choices=["scan", "dense", "incremental"],
                        default="scan",
                        help="encode mode; --dec and --test read it from "
                             "the stream header")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, default=1,
                        help="scan mode: images per step program")
    parser.add_argument("--lanes", type=int, default=None,
                        help="scan mode: arithmetic-coder lanes per stream "
                             "(default: scaled with the image size)")
    args = parser.parse_args(argv)
    n = len(MODEL_SSIM_LIST if args.ssim else MODEL_MSE_LIST)
    if not 0 <= args.model_idx < n:
        parser.error(f"--model-idx must be in [0, {n})")
    if args.enc + args.dec + args.test != 1:
        parser.error("set exactly one of --enc / --dec / --test")

    def names(lst, fname):
        return lst if lst is not None else (read_list(fname) if fname
                                            else None)

    img = names(args.img_list, args.img_file)
    code = names(args.code_list, args.code_file)
    out = names(args.out_list, args.out_file)
    mse = not args.ssim
    if args.enc:
        if not img or len(img) != len(code or []):
            parser.error("--enc needs image and code lists of one length")
        return encoding(img, code, args.model_idx, mse, args.device,
                        args.mode, args.batch, args.lanes)
    if args.dec:
        if not code or len(code) != len(out or []):
            parser.error("--dec needs code and output lists of one length")
        return decoding(code, out, args.model_idx, mse, args.device)
    if not code or len(code) != len(img or []):
        parser.error("--test needs code and image lists of one length")
    return decoding_and_test(code, img, args.model_idx, mse, args.device)


if __name__ == "__main__":
    main()
