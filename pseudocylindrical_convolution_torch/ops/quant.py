"""Learned non-uniform scalar quantizer (pseudo_quant / pseudo_dquant).

Behavioral reference: extension/pseudo_quant_cuda.cu and
extension/pseudo_dquant_cuda.cu; the port of the JAX package's
``ops/quant.py``. ``weight`` is (C, bins); level values are
L[c,0] = w[c,0], L[c,j] = L[c,j-1] + exp(w[c,j]).

The codec calls ``pseudo_quant`` (int64 level index) and
``pseudo_dquant``. Training calls ``PseudoQuant``, whose backward has the
reference's three gradient paths (pseudo_quant_cuda.cu:196-298):

  * data grad: straight-through copy of the dequantized output's grad,
    plus top_alpha * (index output's grad) / beta, beta a local
    gap-derived slope, masked to the valid region;
  * weight grad: the sum of the quantization error (top - x) over
    positions with q >= j, scaled by exp(w_j) for j > 0; it does not
    depend on the cotangents (a built-in centroid-fitting update);
  * count "grad": the negative usage histogram, returned as an output
    for the trainer's SGD step on its ``count`` buffer.

As in the JAX package, both cotangent-free paths are divided by the
leading dim N (= batch * npart) instead of the reference's raw sums, so a
data-parallel mean equals the single-device gradient.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pseudo_quant", "pseudo_dquant", "quant_init_weight",
           "quant_levels", "PseudoQuant", "quant_update_weight"]


def quant_init_weight(channels: int, bins: int = 8) -> np.ndarray:
    """Initial weights (PCONV_operator/PseudoContextV2.py:245-249)."""
    ta = 1.0 / (bins + 1)
    w = np.full((channels, bins), np.log(ta), dtype=np.float32)
    w[:, 0] = ta
    return w


def quant_levels(weight: torch.Tensor) -> torch.Tensor:
    """(C, bins) raw weights -> (C, bins) level values (cumsum of exp)."""
    gaps = torch.cat([weight[:, :1], torch.exp(weight[:, 1:])], dim=1)
    return torch.cumsum(gaps, dim=1)


def _quantize(x: torch.Tensor, levels: torch.Tensor, mask: torch.Tensor):
    """Nearest level of each x (N, C, H, W) among ``levels`` (C, bins):
    (top, q int64), both 0 outside the mask."""
    mids = 0.5 * (levels[:, :-1] + levels[:, 1:])      # (C, bins-1)
    # q = number of midpoints <= x (ties -> upper bin, matching the strict
    # '< midpoint' test in pseudo_quant_cuda.cu:77-80)
    q = (x[..., None] >= mids[None, :, None, None, :]).sum(-1)
    keep = mask > 0
    return torch.where(keep, _take(levels, q), 0.0), torch.where(keep, q, 0)


def _take(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """table (C, bins), q (N, C, H, W) int64 -> table[c, q] per element."""
    return torch.gather(table[None, :, None, None, :].expand(
        *q.shape, table.shape[1]), -1, q[..., None])[..., 0]


def pseudo_quant(x: torch.Tensor, weight: torch.Tensor, mask: torch.Tensor):
    """Nearest-level quantization. x: (N, C, H, W); mask broadcastable
    (N, 1, H, W). Returns (top, q) with q the int64 level index; both are
    0 outside the mask."""
    return _quantize(x, quant_levels(weight), mask)


def pseudo_dquant(qidx: torch.Tensor, weight: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Integer indices -> level values (pseudo_dquant_cuda.cu:23-47)."""
    levels = quant_levels(weight)
    q = qidx.to(torch.int64)
    out = torch.gather(levels[None, :, None, None, :].expand(
        *q.shape, levels.shape[1]), -1, q[..., None])[..., 0]
    return out * mask


def _levels_seq(weight: torch.Tensor) -> torch.Tensor:
    """``quant_levels`` summed one bin after the other: torch's CUDA
    cumsum has no deterministic mode, and training may need one."""
    gaps = torch.cat([weight[:, :1], torch.exp(weight[:, 1:])], dim=1)
    cols = [gaps[:, 0]]
    for j in range(1, gaps.shape[1]):
        cols.append(cols[-1] + gaps[:, j])
    return torch.stack(cols, dim=1)


class PseudoQuant(torch.autograd.Function):
    """Training quantizer: (x, weight, mask, top_alpha) -> (top, q, hist).

    x: (N, C, H, W); mask broadcastable (N, 1, H, W). ``top`` is the
    nearest level, ``q`` its index as float (both 0 outside the mask),
    ``hist`` (C, bins) the negative usage histogram over N (no
    gradient). See the module docstring for the backward."""

    @staticmethod
    def forward(ctx, x, weight, mask, top_alpha=1e-4):
        bins = weight.shape[1]
        top, q = _quantize(x, _levels_seq(weight), mask)
        onehot = torch.nn.functional.one_hot(q, bins).to(x.dtype)
        hist = -(onehot * mask[..., None]).sum(dim=(0, 2, 3)) / x.shape[0]
        ctx.save_for_backward(x, weight, mask, top, q)
        ctx.top_alpha = top_alpha
        ctx.mark_non_differentiable(hist)
        return top, q.to(x.dtype), hist

    @staticmethod
    def backward(ctx, g_top, g_q, _):
        x, weight, mask, top, q = ctx.saved_tensors
        bins = weight.shape[1]
        gaps = torch.exp(weight)                # gaps[:, 0] unused as a gap
        wgrad = None
        if ctx.needs_input_grad[1]:
            err = (top - x) * mask
            sel = (q[..., None] >= torch.arange(bins, device=q.device)
                   ).to(x.dtype)
            wgrad = (err[..., None] * sel).sum(dim=(0, 2, 3)) / x.shape[0]
            wgrad = wgrad * torch.cat([torch.ones_like(gaps[:, :1]),
                                       gaps[:, 1:]], dim=1)
        dx = None
        if ctx.needs_input_grad[0]:
            # beta per element (pseudo_quant_top_diff_kernel, :231-261)
            g_cur = _take(gaps, q.clamp(1, bins - 1))    # exp(w_q), q >= 1
            g_nxt = _take(gaps, (q + 1).clamp(1, bins - 1))
            big = torch.full_like(x, 10000.0)
            beta_lt = torch.where(q < bins - 1, g_nxt, big)     # top < x
            beta_gt = torch.where(q > 0, g_cur, big)            # top > x
            beta_eq = torch.where(q == 0, g_nxt, torch.where(
                q < bins - 1, 0.5 * (g_cur + g_nxt), g_cur))
            beta = torch.where(top < x, beta_lt,
                               torch.where(top > x, beta_gt, beta_eq))
            beta = beta.clamp_min(0.001)
            dx = (g_top + ctx.top_alpha * g_q / beta) * mask
        return dx, wgrad, None, None


def quant_update_weight(weight: torch.Tensor, count: torch.Tensor,
                        bins: int = 8) -> torch.Tensor:
    """Bin-merging maintenance step (pseudo_quant_check_weight, :96-116).

    Run every ``check_iters`` training steps; returns the new weight (the
    caller also decays ``count``)."""
    jr = torch.arange(bins, device=weight.device)
    # j = largest index in [2, bins-1] with count[c, j] >= 1e-3, else 1
    used = (count >= 1e-3) & (jr[None, :] >= 2)
    last = (bins - 1) - torch.argmax(used.flip(1).to(torch.int8), dim=1)
    j = torch.where(used.any(dim=1), last, 1)
    wj = torch.gather(weight, 1, j[:, None])[:, 0]
    tmp = wj - torch.log((bins - j).to(weight.dtype))
    w = torch.where(jr[None, :] >= j[:, None], tmp[:, None], weight)
    # level 0 unused: shift w0 up by one gap and split the next two gaps
    unused0 = count[:, 0] < 1e-3
    w0 = w[:, 0] + torch.exp(w[:, 1])
    t2 = torch.log((torch.exp(w[:, 1]) + torch.exp(w[:, 2])) / 2)
    w = w.clone()
    w[:, 0] = torch.where(unused0, w0, w[:, 0])
    w[:, 1] = torch.where(unused0, t2, w[:, 1])
    w[:, 2] = torch.where(unused0, t2, w[:, 2])
    return w
