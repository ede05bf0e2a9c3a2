"""Class-style codec API after the reference's PseudoEncoder /
PseudoDecoder objects (pseudo_codec.py:162-213); the port of the JAX
package's ``codec/api.py``.

The functional modules (codec/wavefront_scan.py, codec/pipeline.py,
codec/incremental.py) are the primary interfaces; these wrappers bundle a
``CMPNet``, its geometry and a device. Encoding names the mode ("scan" is
the default, as in the CLI); decoding is self-describing: the stream
header selects the decoder.
"""

from __future__ import annotations

import numpy as np
import torch

from pseudocylindrical_convolution_torch.codec import container
from pseudocylindrical_convolution_torch.codec.incremental import (
    incr_decode_images, incr_encode_images)
from pseudocylindrical_convolution_torch.codec.pipeline import (
    decode_image, encode_images)
from pseudocylindrical_convolution_torch.codec.wavefront_scan import (
    scan_decode_images, scan_encode_images)
from pseudocylindrical_convolution_torch.models.cmpnet import CMPNet

MODES = ("scan", "dense", "incremental")


def encode_any(model: CMPNet, images, fnames, mode: str = "scan",
               batch: int = 1, lanes: int | None = None,
               device="cuda") -> list:
    """Encode (1, 3, H, W) images (values in [0, 1]) to stream files in
    ``mode``; returns the file sizes."""
    geom = model.cfg.geometry()
    if mode == "scan":
        return scan_encode_images(model, images, geom, fnames, batch=batch,
                                  lanes=lanes, device=device)
    if mode == "dense":
        return encode_images(model, images, geom, fnames, device=device)
    if mode == "incremental":
        return incr_encode_images(model, images, geom, fnames,
                                  device=device)
    raise ValueError(f"mode {mode!r} is not one of {MODES}")


def decode_any(model: CMPNet, fnames, device="cuda") -> torch.Tensor:
    """Decode stream files of one mode and one size -> (N, 3, H, W)
    float32 images on the device; the headers name the mode and the
    size."""
    geom = model.cfg.geometry()
    hdrs = [container.read_stream(fn) for fn in fnames]
    modes = {h["mode"] for h in hdrs}
    if len(modes) != 1:
        raise ValueError(f"mixed stream modes in one decode: {modes}")
    sizes = {(int(h["h"]) * geom.npart * 8, int(h["w"]) * 8) for h in hdrs}
    if len(sizes) != 1:
        raise ValueError(f"mixed stream sizes in one decode: {sizes}")
    mode, image_hw = modes.pop(), sizes.pop()
    if mode == container.MODE_SCAN:
        return scan_decode_images(model, geom, list(fnames), image_hw,
                                  device=device)
    if mode == container.MODE_INCR:
        return incr_decode_images(model, geom, list(fnames), image_hw,
                                  device=device)
    if mode == container.MODE_DENSE:
        return decode_image(model, geom, list(fnames), image_hw,
                            device=device)
    raise ValueError(f"unknown stream mode {mode}")


class PseudoEncoder:
    """Image(s) -> bitstream file(s).

    mode: "scan" (the step codec of the CLI's default), "dense" (one
    network pass at encode, one per step at decode) or "incremental"
    (frontier cells only, step by step)."""

    def __init__(self, model: CMPNet, mode: str = "scan", batch: int = 1,
                 lanes: int | None = None, device="cuda"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        self.model, self.mode = model, mode
        self.batch, self.lanes, self.device = batch, lanes, device

    def __call__(self, x, code_name):
        """x: (1, 3, H, W) array or a list of them; code_name: str or list.
        Returns the stream size(s) in bytes."""
        single = not isinstance(code_name, (list, tuple))
        xs = [x] if single else list(x)
        fns = [code_name] if single else list(code_name)
        sizes = encode_any(self.model, xs, fns, self.mode, self.batch,
                           self.lanes, self.device)
        return sizes[0] if single else sizes


class PseudoDecoder:
    """Bitstream file(s) -> image(s); the container header picks the mode
    and the image size."""

    def __init__(self, model: CMPNet, device="cuda"):
        self.model, self.device = model, device

    def __call__(self, code_name) -> np.ndarray:
        """-> (N, 3, H, W) float32 numpy images (N=1 for one name)."""
        fns = ([code_name] if not isinstance(code_name, (list, tuple))
               else list(code_name))
        return decode_any(self.model, fns, self.device).cpu().numpy()
