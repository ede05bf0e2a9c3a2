"""GDN / IGDN masked to the valid band region.

Behavioral reference: PCONV_operator/PseudoContextV2.py:133-216 (PseudoGDNV2)
and PCONV_operator/GDN.py:6-22 (LowerBound clamp with gradient gating).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.ops.fill import _fill_mask_t

__all__ = ["GDN", "gdn_apply", "gdn_masked", "lower_bound"]

_REPARAM_OFFSET = 2.0 ** -18
_PEDESTAL = _REPARAM_OFFSET ** 2
_BETA_MIN = 1e-6
_BETA_BOUND = (_BETA_MIN + _PEDESTAL) ** 0.5
_GAMMA_BOUND = _REPARAM_OFFSET


class LowerBound(torch.autograd.Function):
    """max(x, bound) whose gradient passes where x was not clamped, or
    where it pushes x upward (g < 0 raises x under gradient descent;
    GDN.py:15-21)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x >= bound)
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (kept,) = ctx.saved_tensors
        return torch.where(kept | (g < 0), g, 0.0), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return LowerBound.apply(x, bound)


def gdn_masked(beta: torch.Tensor, gamma: torch.Tensor, x: torch.Tensor,
               mask: torch.Tensor, inverse: bool = False,
               dtype=None) -> torch.Tensor:
    """GDN of x (n, C, h, W) whose valid region is ``mask`` (n, 1, h, W).

    With ``dtype=torch.bfloat16`` the channel contraction takes x^2 and
    gamma in bf16 (its output rounded to bf16, then fp32); all else is
    fp32, as in the JAX package's ``gdn_apply(..., dtype)``."""
    x = x * mask
    b = lower_bound(beta, _BETA_BOUND) ** 2 - _PEDESTAL
    g = lower_bound(gamma, _GAMMA_BOUND) ** 2 - _PEDESTAL
    # 1x1 conv on x^2: out[o] = sum_i gamma[o, i] * x2[i] + beta[o]
    if dtype is None:
        norm = torch.einsum("nihw,oi->nohw", x * x, g)
    else:
        norm = torch.einsum("nihw,oi->nohw", (x * x).to(dtype),
                            g.to(dtype)).float()
    norm = torch.sqrt(norm + b[None, :, None, None])
    norm = norm * mask + (1.0 - mask)
    return x * norm if inverse else x / norm


def gdn_apply(beta: torch.Tensor, gamma: torch.Tensor, x: torch.Tensor,
              geom: Geometry, inverse: bool = False,
              dtype=None) -> torch.Tensor:
    """x: (N*npart, C, h, W), all ``npart`` bands of N images."""
    nb, ch, h, w = x.shape
    m = _fill_mask_t(geom, h, w, 0, 0, str(x.device))
    mask = m.to(x.dtype).reshape(1, geom.npart, 1, h, w).expand(
        nb // geom.npart, geom.npart, 1, h, w).reshape(nb, 1, h, w)
    return gdn_masked(beta, gamma, x, mask, inverse, dtype)


class GDN(nn.Module):
    """GDN (or IGDN with ``inverse=True``) with the reference's reparam."""

    def __init__(self, ch: int, inverse: bool = False,
                 gamma_init: float = 0.1):
        super().__init__()
        self.inverse = inverse
        self.beta = nn.Parameter(torch.as_tensor(
            np.sqrt(np.ones(ch) + _PEDESTAL), dtype=torch.float32))
        self.gamma = nn.Parameter(torch.as_tensor(
            np.sqrt(gamma_init * np.eye(ch) + _PEDESTAL), dtype=torch.float32))

    def forward(self, x: torch.Tensor, ctx, dtype=None) -> torch.Tensor:
        """ctx: the block's ``ops.bandctx.BandCtx``."""
        return ctx.gdn(self.beta, self.gamma, x, self.inverse, dtype)
