"""Per-image difficulty scores for the balanced sampler.

The port of the JAX package's ``train/difficulty.py``. The reference
ships a precomputed ``train_val.dic`` pickle (SphereDataset.py:39) without
the generator. Difficulty here is the encoded bpp under a trained model
(images that cost more bits are harder), else a fast gradient-energy
proxy.

  python -m pseudocylindrical_convolution_torch.train.difficulty \
      --img-dir D --list train.txt --out train_val.dic [--model m.pkl ...]

With ``--model`` each image goes through the port's dense encoder
(``codec/pipeline.py::encode_images``) with the transforms in fp32, on
``--device`` (the card by default). The JAX package runs its transforms in
bf16 there, so the two give slightly different scores.
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile

import numpy as np


def gradient_energy(img: np.ndarray) -> float:
    """Cheap texture proxy: mean |dx| + |dy| over the image in [0,1]."""
    g = img.mean(axis=0)
    return float(np.abs(np.diff(g, axis=0)).mean()
                 + np.abs(np.diff(g, axis=1)).mean()) * 100.0


def model_scores(names, img_dir: str, model_path: str, valid_dim: int,
                 device="cuda") -> dict:
    """{name (.npy -> .png): encoded bpp} under the model at
    ``model_path``, dense mode."""
    from pseudocylindrical_convolution_torch.codec.pipeline import (
        encode_images)
    from pseudocylindrical_convolution_torch.models.cmpnet import (
        CMPNetConfig)
    from pseudocylindrical_convolution_torch.train.dataset import load_image
    from pseudocylindrical_convolution_torch.utils.checkpoint import (
        load_model)
    cfg = CMPNetConfig(valid_dim=valid_dim)
    geom = cfg.geometry()
    model = load_model(model_path, cfg, device)
    scores = {}
    with tempfile.TemporaryDirectory() as tmp:
        fn = os.path.join(tmp, "img.bin")
        for n in names:
            x = load_image(os.path.join(img_dir, n))[None]
            (size,) = encode_images(model, [x], geom, [fn], device=device)
            scores[n.replace("npy", "png")] = (size * 8 / x.shape[2]
                                               / x.shape[3])
    return scores


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--img-dir", required=True)
    ap.add_argument("--list", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default="",
                    help="optional .pkl params; difficulty = encode bpp")
    ap.add_argument("--valid-dim", type=int, default=192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from pseudocylindrical_convolution_torch.train.dataset import load_image
    with open(args.list) as f:
        names = [ln.rstrip("\n") for ln in f if ln.strip()]
    if args.model:
        scores = model_scores(names, args.img_dir, args.model,
                              args.valid_dim, args.device)
    else:
        scores = {n.replace("npy", "png"): gradient_energy(
            load_image(os.path.join(args.img_dir, n))) for n in names}
    with open(args.out, "wb") as f:
        pickle.dump(scores, f)
    vals = np.array(list(scores.values()))
    print(f"wrote {args.out}: {len(scores)} images, "
          f"mean {vals.mean():.3f} min {vals.min():.3f} max {vals.max():.3f}")


if __name__ == "__main__":
    main()
