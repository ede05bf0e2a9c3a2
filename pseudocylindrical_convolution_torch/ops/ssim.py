"""SSIM with an 11x11 Gaussian window (sigma 1.5), zero-padded SAME conv.

The port of the JAX package's ``ops/ssim.py``; behavioral reference
PCONV_operator/pytorch_ssim.py:7-63. The moment filters run in full fp32
(TF32 off): the variance terms are small differences of large windowed
moments, and TF32 products would push the map past [-1, 1] in flat
regions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ssim"]


@functools.lru_cache(maxsize=None)
def _window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    w2 = np.outer(g, g)
    w2.setflags(write=False)
    return w2


def _filter(x: torch.Tensor, w2: np.ndarray) -> torch.Tensor:
    """Depthwise SAME conv with zero padding (conv2d, groups=channel)."""
    c, k = x.shape[1], w2.shape[0]
    w = torch.tensor(w2, device=x.device, dtype=x.dtype)[None, None].expand(
        c, 1, k, k).contiguous()
    return F.conv2d(x, w, padding=k // 2, groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    dt = torch.promote_types(img1.dtype, torch.float32)   # fp32 or fp64
    img1, img2 = img1.to(dt), img2.to(dt)
    w2 = _window(window_size)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        mu1, mu2 = _filter(img1, w2), _filter(img2, w2)
        mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = _filter(img1 * img1, w2) - mu1_sq
        s2 = _filter(img2 * img2, w2) - mu2_sq
        s12 = _filter(img1 * img2, w2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1)
                                              * (s1 + s2 + c2))
    return m.mean() if size_average else m.mean(dim=(1, 2, 3))
