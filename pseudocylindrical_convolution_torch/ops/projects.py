"""MultiProject: render 14 fixed rectilinear viewports from an ERP image.

The port of the JAX package's ``ops/projects.py``; behavioral reference
extension/projects_cuda.cu + projects.hpp (yaw about z by theta, then
pitch about the rotated y axis by -phi) and
PCONV_operator/MultiProject.py:39-40 for the 14 viewport directions. The
sampling grids are static per (h_out, w_out, fov, H, W), so the op is a
precomputed 4-tap bilinear gather. Its backward is the reference
wrapper's, not the gather's adjoint: the scattered gradient divided by
each pixel's summed tap weight (PCONV_operator/MultiProject.py:23:
grad / (count + 1e-6)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["multi_project", "VIEW_THETAS", "VIEW_PHIS"]

VIEW_THETAS = (-0.5, 0, 0.5, 1, -0.5, 0, 0.5, 1, -0.5, 0, 0.5, 1, 0, 0)
VIEW_PHIS = (0, 0, 0, 0, 0.25, 0.25, 0.25, 0.25,
             -0.25, -0.25, -0.25, -0.25, 0.5, -0.5)


def _rodrigues(vec) -> np.ndarray:
    x, y, z = vec
    norm = float(np.sqrt(x * x + y * y + z * z))
    if norm == 0:
        return np.eye(3)
    tx, ty, tz = x / norm, y / norm, z / norm
    c, s = np.cos(norm), np.sin(norm)
    return np.array([
        [c + (1 - c) * tx * tx, (1 - c) * tx * ty - s * tz,
         (1 - c) * tx * tz + s * ty],
        [(1 - c) * ty * tx + s * tz, c + (1 - c) * ty * ty,
         (1 - c) * ty * tz - s * tx],
        [(1 - c) * tz * tx - s * ty, (1 - c) * tz * ty + s * tx,
         c + (1 - c) * tz * tz]])


@functools.lru_cache(maxsize=None)
def _view_grids(h_out: int, w_out: int, fov: float, H: int, W: int,
                thetas: tuple = VIEW_THETAS,
                phis: tuple = VIEW_PHIS) -> np.ndarray:
    """(nview, h_out, w_out, 2) float32 ERP sample coords (x=col, y=row)."""
    pi = np.pi
    nview = len(thetas)
    hfov = fov * pi * h_out / w_out / 2
    wfov = fov * pi / 2
    c_x, c_y = (w_out - 1) / 2.0, (h_out - 1) / 2.0
    w_stride = 2 * np.sin(wfov) / np.sin(pi / 2 - wfov) / (w_out - 1)
    h_stride = 2 * np.sin(hfov) / np.sin(pi / 2 - hfov) / (h_out - 1)
    ww, hh = np.meshgrid(np.arange(w_out), np.arange(h_out))
    x = np.ones_like(ww, dtype=np.float64)
    y = (ww - c_x) * w_stride
    z = (hh - c_y) * h_stride
    r = np.sqrt(x * x + y * y + z * z)
    xyz = np.stack([x / r, y / r, -z / r], axis=-1)   # (h, w, 3)
    grids = np.zeros((nview, h_out, w_out, 2), dtype=np.float32)
    for v in range(nview):
        r1 = _rodrigues((0.0, 0.0, thetas[v] * pi))
        axis = r1[:, 1] * (-phis[v] * pi)             # rotated y axis * -phi
        r2 = _rodrigues(tuple(axis))
        p = xyz @ (r2 @ r1)                           # row-vector transform
        lat = np.arcsin(np.clip(p[..., 2], -1, 1))
        theta = np.arctan(p[..., 1] / p[..., 0])
        neg = p[..., 0] <= 0
        theta = np.where(neg & (p[..., 1] > 0), theta + pi,
                         np.where(neg & (p[..., 1] <= 0), theta - pi, theta))
        hx, hy = (W - 1) / 2.0, (H - 1) / 2.0
        grids[v, ..., 0] = theta / pi * hx + hx
        grids[v, ..., 1] = -2 * lat / pi * hy + hy
    grids.setflags(write=False)
    return grids


def _bilinear_taps(grids: np.ndarray, H: int, W: int) -> list:
    """4-tap (flat index, weight) tables; col wraps, row clamps
    (projects_forward_kernel, projects_cuda.cu:180-198)."""
    gx, gy = grids[..., 0], grids[..., 1]
    tw = np.floor(gx).astype(np.int64)
    th = np.floor(gy).astype(np.int64)
    pw = (tw + 1) % W
    ph = np.minimum(th + 1, H - 1)
    tx, ty = gx - tw, gy - th
    return [((r * W + c).astype(np.int64), w.astype(np.float32))
            for r, c, w in ((th, tw, (1 - tx) * (1 - ty)),
                            (th, pw, tx * (1 - ty)),
                            (ph, tw, (1 - tx) * ty), (ph, pw, tx * ty))]


@functools.lru_cache(maxsize=None)
def _device_taps(h_out: int, w_out: int, fov: float, H: int, W: int,
                 thetas: tuple, phis: tuple, device: str):
    """The 4 taps' flat indices and weights on ``device``, each (4,
    nview*h_out*w_out), and the per-pixel tap weight sum (H*W,) that the
    backward divides by; uploaded once per (shape, device)."""
    grids = _view_grids(h_out, w_out, fov, H, W, thetas, phis)
    taps = _bilinear_taps(grids, H, W)
    cnt = np.zeros(H * W, np.float32)
    for i, w in taps:
        np.add.at(cnt, i.reshape(-1), w.reshape(-1))
    dev = torch.device(device)
    return (torch.tensor(np.stack([i.reshape(-1) for i, _ in taps]),
                         device=dev),
            torch.tensor(np.stack([w.reshape(-1) for _, w in taps]),
                         device=dev),
            torch.tensor(cnt, device=dev))


class _MultiProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h_out, w_out, fov, thetas, phis):
        n, c, H, W = x.shape
        idx, wgt, cnt = _device_taps(h_out, w_out, fov, H, W, thetas, phis,
                                     str(x.device))
        xf = x.reshape(n, c, H * W)
        out = 0.0
        for k in range(4):
            out = out + xf[:, :, idx[k]] * wgt[k]
        ctx.taps = (idx, wgt, cnt)
        ctx.shape = (n, c, H, W)
        nv = len(thetas)
        return out.reshape(n, c, nv, h_out, w_out).permute(
            0, 2, 1, 3, 4).reshape(n * nv, c, h_out, w_out)

    @staticmethod
    def backward(ctx, g):
        idx, wgt, cnt = ctx.taps
        n, c, H, W = ctx.shape
        gg = g.reshape(n, -1, c, g.shape[-2] * g.shape[-1]).permute(
            0, 2, 1, 3).reshape(n, c, -1)
        acc = torch.zeros((n, c, H * W), dtype=g.dtype, device=g.device)
        for k in range(4):
            acc.index_add_(2, idx[k], gg * wgt[k])
        dx = acc / (cnt + 1e-6)
        return dx.reshape(n, c, H, W), None, None, None, None, None


def multi_project(x: torch.Tensor, h_out: int = 171, w_out: int = 256,
                  fov: float = 0.5, thetas: tuple = VIEW_THETAS,
                  phis: tuple = VIEW_PHIS) -> torch.Tensor:
    """(N, C, H, W) ERP -> (N*nview, C, h_out, w_out) viewports, views of
    one image together. Custom (thetas, phis) tuples give MultiProjectM
    semantics (PCONV_operator/MultiProject.py:25-33)."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))   # fp32 or fp64
    return _MultiProject.apply(x, h_out, w_out, fov, tuple(thetas),
                               tuple(phis))
