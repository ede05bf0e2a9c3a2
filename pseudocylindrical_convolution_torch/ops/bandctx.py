"""Band context: the transforms' geometry ops, on all bands or on a block.

The port of the JAX package's ``ops/bandctx.py``. The transform blocks
(models/transform.py) touch the sphere geometry only through three ops:
pseudo_pad, pseudo_fill and GDN. A ``BandCtx`` bundles those three, so one
block code runs either

  * globally (``GlobalBands``): the tensor holds all ``npart`` latitude
    bands of each image (one device, or data-parallel ranks); or
  * locally (``LocalBands``): the tensor holds one rank's contiguous block
    of ``npart // world`` bands of one image, in a process group where
    every rank runs the same program (parallel/spatial.py).

The only cross-band coupling of the transform stack is pseudo_pad's
vertical rows: band g's top and bottom pad interpolate the neighbouring
band's boundary rows (pole rows reflect within the polar band, so the poles
stay local). ``LocalBands.pad`` therefore fetches ``pad`` boundary rows
from each ring neighbour (``HaloExchange``, point-to-point sends over the
process group, with the reverse sends as its backward) and gathers through
tables remapped into the rank's [halo | own rows | halo] row space.
``GatheredBands`` is the simple alternative that all-gathers the whole
tensor before each pad.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.ops.fill import (
    _fill_mask, pseudo_fill)
from pseudocylindrical_convolution_torch.ops.gdn import gdn_apply, gdn_masked
from pseudocylindrical_convolution_torch.ops.pad import (
    build_pad_tables, pseudo_pad)

__all__ = ["BandCtx", "GlobalBands", "LocalBands", "GatheredBands",
           "as_band_ctx", "build_local_pad_tables", "all_gather_bands"]


class BandCtx:
    """Interface the transform blocks program against."""

    geom: Geometry

    def pad(self, x, pad: int, causal: bool = False):
        raise NotImplementedError

    def fill(self, x, pad: int = 0, trim: int = 0, fvalue: float = 0.0):
        raise NotImplementedError

    def gdn(self, beta, gamma, x, inverse: bool = False, dtype=None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GlobalBands(BandCtx):
    geom: Geometry

    def pad(self, x, pad, causal=False):
        return pseudo_pad(x, self.geom, pad, causal)

    def fill(self, x, pad=0, trim=0, fvalue=0.0):
        return pseudo_fill(x, self.geom, pad, trim, fvalue)

    def gdn(self, beta, gamma, x, inverse=False, dtype=None):
        return gdn_apply(beta, gamma, x, self.geom, inverse, dtype)


def as_band_ctx(geom_or_ctx) -> BandCtx:
    if isinstance(geom_or_ctx, BandCtx):
        return geom_or_ctx
    return GlobalBands(geom_or_ctx)


# ---------------------------------------------------------------------------
# One rank's band block
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def build_local_pad_tables(geom: Geometry, h: int, width: int, pad: int,
                           ndev: int, causal: bool = False):
    """Per-rank pad tables indexing the rank-local [halo|own|halo] rows.

    Returns (idx, wgt) of shape (ndev, 2, nl, h+2p, W+2p); indices address
    a flattened ((nl*h + 2*pad) * width) buffer whose row r is global tile
    row (rank*nl*h - pad + r). Raises unless every nonzero-weight source
    falls inside that window. The port's copy of the JAX package's
    builder; the two must agree exactly."""
    npart = geom.npart
    if npart % ndev:
        raise ValueError(f"{ndev} ranks do not divide {npart} bands")
    nl = npart // ndev
    idx, wgt = build_pad_tables(geom, h, width, pad, causal)
    h2, w2 = h + 2 * pad, width + 2 * pad
    size = (nl * h + 2 * pad) * width
    li = np.zeros((ndev, 2, nl, h2, w2), np.int32)
    lw = np.zeros((ndev, 2, nl, h2, w2), np.float32)
    for d in range(ndev):
        lo = d * nl
        gi = idx[:, lo:lo + nl].astype(np.int64)
        gw = wgt[:, lo:lo + nl]
        rel = gi - (lo * h - pad) * width
        ok = (gw == 0) | ((rel >= 0) & (rel < size))
        if not ok.all():
            raise ValueError("pad source escapes the halo window")
        li[d] = np.where(gw == 0, 0, np.clip(rel, 0, size - 1))
        lw[d] = gw
    li.setflags(write=False)
    lw.setflags(write=False)
    return li, lw


@functools.lru_cache(maxsize=None)
def _local_pad_index(geom: Geometry, h: int, width: int, pad: int, ndev: int,
                     causal: bool, rank: int, device: str):
    li, lw = build_local_pad_tables(geom, h, width, pad, ndev, causal)
    dev = torch.device(device)
    return (torch.tensor(li[rank].reshape(2, -1), dtype=torch.int64,
                         device=dev),
            torch.tensor(lw[rank].reshape(2, -1), device=dev))


@functools.lru_cache(maxsize=None)
def _local_mask(geom: Geometry, h: int, width: int, pad: int, trim: int,
                ndev: int, rank: int, device: str) -> torch.Tensor:
    m = _fill_mask(geom, h, width, pad, trim)           # (npart, h, w)
    nl = geom.npart // ndev
    return torch.tensor(m[rank * nl:(rank + 1) * nl],
                        device=torch.device(device))[:, None]


def _wire(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the group's backend carries it: gloo moves CUDA tensors
    through host memory for point-to-point and gather ops."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t.contiguous()


def _ring_exchange(fwd: torch.Tensor, bwd: torch.Tensor, group):
    """(the previous rank's ``fwd``, the next rank's ``bwd``): ``fwd`` goes
    one step round the ring to rank + 1, ``bwd`` one step back to
    rank - 1, as one batch of point-to-point ops."""
    group = group if group is not None else dist.group.WORLD
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % world)
    prv = dist.get_global_rank(group, (rank - 1) % world)
    send_f, send_b = _wire(group, fwd), _wire(group, bwd)
    recv_f, recv_b = torch.empty_like(send_f), torch.empty_like(send_b)
    # with two ranks both messages go to the same peer: the tags keep them
    # apart on gloo, and NCCL matches them in the order they are listed
    ops = [dist.P2POp(dist.isend, send_f, nxt, group, tag=0),
           dist.P2POp(dist.isend, send_b, prv, group, tag=1),
           dist.P2POp(dist.irecv, recv_f, prv, group, tag=0),
           dist.P2POp(dist.irecv, recv_b, nxt, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv_f.to(fwd.device), recv_b.to(bwd.device)


class HaloExchange(torch.autograd.Function):
    """(fwd, bwd) -> (the previous rank's fwd, the next rank's bwd).

    The exchange E(a, b) = (S+ a, S- b) shifts a forward and b backward
    round the ring; its adjoint is (S- ga, S+ gb), the same exchange with
    the roles swapped, so the backward sends each halo's gradient back to
    the rank whose rows it came from (the reverse of JAX's ppermute)."""

    @staticmethod
    def forward(ctx, fwd, bwd, group):
        ctx.group = group
        return _ring_exchange(fwd, bwd, group)

    @staticmethod
    def backward(ctx, g_fwd, g_bwd):
        g_b, g_f = _ring_exchange(g_bwd.contiguous(), g_fwd.contiguous(),
                                  ctx.group)
        return g_f, g_b, None


class _GatherBands(torch.autograd.Function):
    """All ranks' blocks concatenated along dim 0, in rank order.

    Every rank then runs the same computation on the whole tensor, so
    every rank's incoming gradient is the same full gradient: the backward
    keeps this rank's slice of it and sums nothing (a summing backward,
    as torch.distributed.nn's all_gather has, would scale the gradient by
    the world size)."""

    @staticmethod
    def forward(ctx, x, group):
        world = dist.get_world_size(group)
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[0]
        if world == 1:
            return x.clone()
        wire = _wire(group, x)
        parts = [torch.empty_like(wire) for _ in range(world)]
        dist.all_gather(parts, wire, group=group)
        return torch.cat(parts).to(x.device)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def all_gather_bands(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's (nl, ...) block -> the whole (world*nl, ...) tensor on
    every rank; differentiable (see ``_GatherBands``)."""
    return _GatherBands.apply(x, group)


@dataclasses.dataclass(frozen=True)
class LocalBands(BandCtx):
    """Ops for one rank's contiguous band block.

    Image batch N == 1 (single-image spatial parallelism): the local
    tensors are (nl, C, h, W) with nl = npart // world, rank r holding
    bands [r*nl, (r+1)*nl). ``group`` is the process group of the ranks
    that share the image (None: the default group)."""

    geom: Geometry
    group: object = None

    @property
    def ndev(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def nl(self) -> int:
        return self.geom.npart // self.ndev

    def pad(self, x, pad, causal=False):
        nl, ndev = self.nl, self.ndev
        nb, c, h, w = x.shape
        if nb != nl:
            raise ValueError(f"LocalBands holds {nl} bands, got {nb}")
        idx, wgt = _local_pad_index(self.geom, h, w, pad, ndev, causal,
                                    self.rank, str(x.device))
        # (nl, C, h, W) -> (C, nl*h, W): this block's rows, top to bottom
        xr = x.transpose(0, 1).reshape(c, nl * h, w)
        halo_prev, halo_next = self._halo_rows(xr, pad)
        flat = torch.cat([halo_prev, xr, halo_next], dim=1).reshape(c, -1)
        wgt = wgt.to(x.dtype)
        out = flat[:, idx[0]] * wgt[0] + flat[:, idx[1]] * wgt[1]
        return out.reshape(c, nl, h + 2 * pad, w + 2 * pad).transpose(0, 1)

    def _halo_rows(self, xr, pad):
        """(halo_prev, halo_next): the ``pad`` global rows bordering this
        rank's block, from its ring neighbours.

        One hop moves ``pad`` rows when the block has that many; with
        pad > nl*h (tiny tiles over many ranks) each further hop moves a
        whole block. The ring wraps at the poles, but the tables give the
        wrapped rows zero weight (pole rows reflect within the block)."""
        c, rows, w = xr.shape
        if self.ndev == 1:
            z = xr.new_zeros((c, pad, w))
            return z, z
        if pad <= rows:
            return HaloExchange.apply(xr[:, -pad:], xr[:, :pad], self.group)
        prev_blocks, next_blocks = [], []
        cur_p, cur_n = xr, xr
        for _ in range(min(-(-pad // rows), self.ndev)):
            cur_p, cur_n = HaloExchange.apply(cur_p, cur_n, self.group)
            prev_blocks.insert(0, cur_p)
            next_blocks.append(cur_n)
        return (torch.cat(prev_blocks, dim=1)[:, -pad:],
                torch.cat(next_blocks, dim=1)[:, :pad])

    def _mask(self, x, pad=0, trim=0):
        _, _, h, w = x.shape
        return _local_mask(self.geom, h, w, pad, trim, self.ndev, self.rank,
                           str(x.device)).to(x.dtype)

    def fill(self, x, pad=0, trim=0, fvalue=0.0):
        mask = self._mask(x, pad, trim)
        if fvalue == 0.0:
            return x * mask
        return x * mask + (1.0 - mask) * fvalue

    def gdn(self, beta, gamma, x, inverse=False, dtype=None):
        return gdn_masked(beta, gamma, x, self._mask(x), inverse, dtype)


@dataclasses.dataclass(frozen=True)
class GatheredBands(LocalBands):
    """``LocalBands`` whose pad all-gathers the whole tensor, pads it with
    the global tables and keeps this rank's block: the simple reference
    the halo exchange is tested beside. It moves the whole tensor to every
    rank before each pad, where the halo exchange moves 2*pad rows."""

    def pad(self, x, pad, causal=False):
        full = all_gather_bands(x, self.group)
        out = pseudo_pad(full, self.geom, pad, causal)
        return out[self.rank * self.nl:(self.rank + 1) * self.nl]
