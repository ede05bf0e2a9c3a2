"""Incremental wavefront codec mode (``MODE_INCR`` streams).

The port of the JAX package's ``codec/incremental.py``. The dense decode
(codec/pipeline.py) runs the whole causal network every step; here every
layer keeps a persistent activation buffer and a step computes only the
new frontier cells, one anti-diagonal per channel group:

  * for a cell at (group g, band b, row r, col j = z - g - h*b - r), the
    tap (kh, kw) reads slab column m = (G + h - 2) - g - r + kw, which
    does not depend on z or b. So a step gathers, per band, a narrow
    causally-padded slab through the composed 2-tap pad tables, then
    contracts it with the 25 taps, then deposits the new cells;
  * the slab is read through the double skew of the JAX package (its
    ``G2``/``We`` einsum): with the slab's columns reversed and padded,
    the operand of row r, tap row k, group g and diagonal e is one strided
    view, Q[r+k, r+k+g+e], so the 25-tap contraction of every (subnet,
    group) is one batched matmul.

Bit-exactness: encoder and decoder run the same step function on the
same shapes (the encoder teacher-forces the known symbols), so their CDF
rows agree by construction. Each frontier cell is deposited once, into a
zero target, and only valid cells are written, so no two writes meet. The
two modes write different streams.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from pseudocylindrical_convolution_torch.codec import container
from pseudocylindrical_convolution_torch.codec.coder_bridge import Coder
from pseudocylindrical_convolution_torch.codec.pipeline import (
    BIAS, NSTEP, TOTAL, _unpack_step_tables, decode_image_from_latents,
    encode_latents_plane)
from pseudocylindrical_convolution_torch.codec.wavefront import (
    wavefront_schedule)
from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, CMPNetConfig)
from pseudocylindrical_convolution_torch.models.entropy import (
    stack_step_weights)
from pseudocylindrical_convolution_torch.ops.gmm_table import gmm_cdf_table
from pseudocylindrical_convolution_torch.ops.pad import build_pad_tables
from pseudocylindrical_convolution_torch.utils.device import (
    check_model, pin_numerics, resolve_device)


@functools.lru_cache(maxsize=None)
def _static_tables(geom: Geometry, h: int, w: int):
    """Causal pad tables with an extra sentinel column (weight 0), so
    out-of-range window columns can be clamped there."""
    idx, wgt = build_pad_tables(geom, h, w, 2, causal=True)
    npart = geom.npart
    idxp = np.concatenate([idx, np.zeros((2, npart, h + 4, 1), np.int32)],
                          axis=3)
    wgtp = np.concatenate([wgt, np.zeros((2, npart, h + 4, 1), np.float32)],
                          axis=3)
    idxp.setflags(write=False)
    wgtp.setflags(write=False)
    return idxp, wgtp


def _skew_weights(w: torch.Tensor) -> torch.Tensor:
    """(..., 5, 5) taps (kh, kw) -> (..., 5, 9) over (kh, e') with
    e' = 8 - kh - kw: the JAX package's We[..., kh, e] = W[..., kh, e-kh]
    with the diagonal axis reversed to match the reversed slab."""
    return torch.stack([F.pad(w[..., kh, :].flip(-1), (4 - kh, kh))
                        for kh in range(5)], dim=-2)


class WavefrontCodec:
    """Incremental wavefront encoder/decoder for one latent geometry
    (one image at a time)."""

    def __init__(self, cfg: CMPNetConfig, geom: Geometry, h: int, w: int,
                 cpn: int = 3, num_gaussian: int = 3, device="cuda"):
        self.device = dev = resolve_device(device)
        pin_numerics()
        self.cfg, self.geom, self.h, self.w = cfg, geom, h, w
        self.cpn, self.ng = cpn, num_gaussian
        G = cfg.ngroup
        npart = geom.npart
        self.G, self.npart = G, npart
        self.h_out = h * npart
        self.S = npart * h * w                  # buffer columns
        self.N = npart * h                      # frontier cells per group
        self.SW = G + h + 3                     # slab width (taps inclusive)
        self.L = self.SW + 8                    # reversed slab, 4 zeros a side
        order, counts, nsteps = wavefront_schedule(geom, h, w, G)
        self.counts, self.nsteps = counts, nsteps
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)
        self.maxlen = int(counts.max())
        i, j, g = (order[:, k].astype(np.int64) for k in range(3))
        self.plane_idx = ((i // h * G + g) * h + i % h) * w + j

        def dt(a, dtype=torch.int64):
            return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=dev)

        self._grid = dt(g * self.h_out + i)             # CDF grid row
        self._in_idx = dt(g * self.S + (i * w + j))     # input buffer (G, S)
        self._slab_idx, self._slab_wgt = self._slab_tables(dt)
        self._dep_src, self._dep_dst, self._dep_off = self._deposit_tables(
            dt)
        self._weights = None
        self._prepared_src = None

    # ------------------------------------------------------------------
    def _slab_tables(self, dt):
        """Per step, the 2-tap gather of the reversed, zero-padded slab:
        idx/wgt (nsteps, 2, npart, h+4, L). Column m' of the result is slab
        column SW+3-m' (the JAX ``_slab``'s padded column colstart+m+2 of
        band b); columns outside the slab or the padded plane take the
        sentinel (weight 0)."""
        idxp, wgtp = _static_tables(self.geom, self.h, self.w)
        G, h, w, npart, SW, L = (self.G, self.h, self.w, self.npart,
                                 self.SW, self.L)
        z = np.arange(self.nsteps)[:, None, None]
        b = np.arange(npart)[None, :, None]
        m = SW + 3 - np.arange(L)[None, None, :]
        cprime = z - h * b - G - h + 2 + m
        oob = (m < 0) | (m >= SW) | (cprime < 0) | (cprime >= w + 4)
        cc = np.where(oob, w + 4, cprime)[:, :, None, :]
        bb = np.arange(npart)[None, :, None, None]
        tt = np.arange(h + 4)[None, None, :, None]
        idx = np.stack([idxp[k][bb, tt, cc] for k in range(2)], axis=1)
        wgt = np.stack([wgtp[k][bb, tt, cc] for k in range(2)], axis=1)
        return dt(idx), dt(wgt, torch.float32)

    def _deposit_tables(self, dt):
        """Valid frontier cells of every step: (src, dst, step offsets).
        src indexes a step's cells (3, G, cpn, N) per subnet, dst a hidden
        buffer (3, G*cpn, S) per subnet; each buffer cell is written at
        exactly one step."""
        G, h, w, cpn, N, S = self.G, self.h, self.w, self.cpn, self.N, self.S
        wl = np.asarray(self.geom.hindex(self.h_out, w), np.int64)
        z = np.arange(self.nsteps)[:, None, None, None]
        b = np.arange(self.npart)[None, :, None, None]
        r = np.arange(h)[None, None, :, None]
        g = np.arange(G)[None, None, None, :]
        j = z - g - (h * b + r)
        valid = (j >= 0) & (j < wl[b])
        zs, bs, rs, gs = np.nonzero(valid)
        js = zs - gs - (h * bs + rs)
        o = np.arange(cpn)[None, :]
        cell = (bs * h + rs)[:, None]
        src = (gs[:, None] * cpn + o) * N + cell
        dst = (gs[:, None] * cpn + o) * S + cell * w + js[:, None]
        off = np.concatenate([[0], np.cumsum(np.bincount(
            zs, minlength=self.nsteps))]) * cpn
        return dt(src.reshape(-1)), dt(dst.reshape(-1)), off

    @torch.no_grad()
    def prepare(self, ent) -> "WavefrontCodec":
        """Mask, stack and skew the entropy weights (``CMPNet.ent``) into
        one matmul operand per layer: "w" (3, G, cout, C*45) over
        (c, kh, e'), "b" and "a" (3, G, cout, 1)."""
        if self._prepared_src is ent:
            return self
        G = self.G
        self._weights = []
        for lay in stack_step_weights(ent, G, self.cpn, self.ng):
            wt = lay["w"].to(self.device, torch.float32)
            cout = wt.shape[2]

            def col(t):
                return None if t is None else t.to(
                    self.device, torch.float32).reshape(3, G, cout, 1)

            self._weights.append({
                "w": _skew_weights(wt).reshape(3, G, cout, -1).contiguous(),
                "b": col(lay["b"]), "a": col(lay["a"])})
        self._prepared_src = ent
        return self

    # ------------------------------------------------------------------
    def _slab(self, buf: torch.Tensor, z: int) -> torch.Tensor:
        """The reversed, zero-padded slab of step z: (..., C, npart, h+4,
        L) from a (..., C, S) channel-major buffer."""
        idx, wgt = self._slab_idx[z], self._slab_wgt[z]
        return buf[..., idx[0]] * wgt[0] + buf[..., idx[1]] * wgt[1]

    def _frontier_conv(self, buf: torch.Tensor, z: int,
                       layer: dict) -> torch.Tensor:
        """New frontier cells of one layer, (3, G, cout, N) after bias and
        PReLU. buf: (3, C, S), or (G, S) for the input plane, shared by
        the three subnets.

        Z[..., c, b, r, k, g, e'] = Q[..., c, b, r+k, r+k+g+e'] is the JAX
        ``G2[..., r+k, g, e]`` (e = 8 - e') read as one strided view of the
        slab Q; its copy in (group, (c, k, e'), (b, r)) order is the
        batched matmul's operand."""
        G, h, L = self.G, self.h, self.L
        q = self._slab(buf, z).contiguous()
        zv = q.as_strided(q.shape[:-2] + (h, 5, G, 9),
                          q.stride()[:-2] + (L + 1, L + 1, 1, 1))
        nd = zv.dim()          # (..., C, npart, h, 5, G, 9)
        zv = zv.permute(*range(nd - 6), nd - 2, nd - 6, nd - 3, nd - 1,
                        nd - 5, nd - 4)
        bm = zv.reshape(*zv.shape[:-6], G, -1, self.N)
        out = torch.matmul(layer["w"], bm) + layer["b"]
        if layer["a"] is not None:
            out = torch.where(out >= 0, out, layer["a"] * out)
        return out

    def _cell_flat_idx(self, z: int):
        """(src, dst) of step z's valid frontier cells (``_deposit_tables``)."""
        a, e = int(self._dep_off[z]), int(self._dep_off[z + 1])
        return self._dep_src[a:e], self._dep_dst[a:e]

    @staticmethod
    def _deposit(buf: torch.Tensor, cells: torch.Tensor, src, dst):
        buf.view(3, -1)[:, dst] = cells.reshape(3, -1)[:, src]

    def _step_impl(self, bufs: list, z: int,
                   raw_out: list | None = None) -> torch.Tensor:
        """One wavefront step on the buffers -> step z's CDF rows, interior
        entries (n, NSTEP-1) int32 in coding order. ``raw_out``, if a list,
        receives the step's raw GMM parameters (3, n, ng) in coding
        order."""
        wts = self._weights
        src, dst = self._cell_flat_idx(z)
        y0 = self._frontier_conv(bufs[0], z, wts[0])
        self._deposit(bufs[1], y0, src, dst)
        ycells = y0
        for r in range(5):
            li = 1 + 2 * r
            c1 = self._frontier_conv(bufs[li], z, wts[li])
            self._deposit(bufs[li + 1], c1, src, dst)
            c2 = self._frontier_conv(bufs[li + 1], z, wts[li + 1])
            ycells = ycells + c2
            self._deposit(bufs[li + 2], ycells, src, dst)
        out = self._frontier_conv(bufs[11], z, wts[11])
        # CDF grid (G*h_out, ng): row g*h_out + (b*h + r)
        prm = out.permute(0, 1, 3, 2).reshape(3, -1, self.ng)
        tb = gmm_cdf_table(prm[0], prm[1], prm[2], NSTEP, BIAS, TOTAL)
        sel = self._grid[int(self.offsets[z]):int(self.offsets[z + 1])]
        if raw_out is not None:
            raw_out.append(prm[:, sel])
        return tb[sel, 1:NSTEP]

    # ------------------------------------------------------------------
    def init_buffers(self) -> list:
        """Input plane (G, S) and 11 activation buffers (3, G*cpn, S),
        channel-major, fp32."""
        dev, C = self.device, self.G * self.cpn
        return ([torch.zeros((self.G, self.S), device=dev)]
                + [torch.zeros((3, C, self.S), device=dev)
                   for _ in range(11)])

    @torch.no_grad()
    def _run(self, payload: bytes | None = None, teacher=None,
             raw_out: list | None = None):
        """Drive the step loop. Encode (``teacher``: (nsym,) int64 symbols
        in coding order, on the device): returns the rows of every step,
        (nsym, NSTEP-1) int32 on the device. Decode (``payload``: the AC
        bytes): returns the (nsym,) int64 symbols in coding order.
        ``raw_out`` collects every step's raw parameters (``_step_impl``)."""
        if self._weights is None:
            raise RuntimeError("call prepare(model.ent) first")
        decode = teacher is None
        if decode:
            coder = Coder()
            coder.start_decoder_buf(payload)
            out = np.zeros(int(self.offsets[-1]), np.int64)
        rows = []
        bufs = self.init_buffers()
        for z in range(self.nsteps):
            n = int(self.counts[z])
            if n == 0:
                continue
            o = int(self.offsets[z])
            tb = self._step_impl(bufs, z, raw_out)
            if decode:
                s = coder.decodes(_unpack_step_tables(tb.cpu().numpy()),
                                  NSTEP, n)
                out[o:o + n] = s
                syms = torch.as_tensor(s, device=self.device)
            else:
                rows.append(tb)
                syms = teacher[o:o + n]
            bufs[0].view(-1)[self._in_idx[o:o + n]] = syms.float() - BIAS
        return out if decode else torch.cat(rows)

    def encode(self, hcode_plane, fname: str) -> int:
        """hcode_plane: (npart, G, h, w) integer symbols (tensor or numpy).
        Writes a MODE_INCR container file; returns its size."""
        plane = torch.as_tensor(hcode_plane).to(self.device, torch.int64)
        syms = plane.reshape(-1)[torch.as_tensor(self.plane_idx,
                                                 device=self.device)]
        rows = self._run(teacher=syms)
        coder = Coder()
        coder.start_encoder()
        coder.encodes(_unpack_step_tables(rows.cpu().numpy()), NSTEP,
                      syms.cpu().numpy(), int(self.offsets[-1]))
        return container.write_stream(fname, container.MODE_INCR,
                                      self.npart, self.cfg.valid_dim, self.h,
                                      self.w, coder.end_encoder_buf())

    def decode(self, fname: str) -> np.ndarray:
        """A MODE_INCR container file -> (npart, G, h, w) int64 symbols."""
        hdr = container.read_stream(fname)
        container.check_stream(hdr, fname, container.MODE_INCR, self.npart,
                               self.cfg.valid_dim, self.h, self.w)
        syms = self._run(payload=hdr["payload"])
        plane = np.zeros(self.npart * self.G * self.h * self.w, np.int64)
        plane[self.plane_idx] = syms
        return plane.reshape(self.npart, self.G, self.h, self.w)


# ---------------------------------------------------------------------------
# Image-level incremental-mode API (CLI `--mode incremental`)
# ---------------------------------------------------------------------------

_INCR_CACHE: dict = {}


def get_incremental_codec(cfg: CMPNetConfig, geom: Geometry, h: int, w: int,
                          device="cuda") -> WavefrontCodec:
    dev = resolve_device(device)
    key = (cfg, geom, h, w, str(dev))
    codec = _INCR_CACHE.get(key)
    if codec is None:
        codec = WavefrontCodec(cfg, geom, h, w, device=dev)
        _INCR_CACHE[key] = codec
    return codec


@torch.no_grad()
def incr_encode_images(model: CMPNet, images, geom: Geometry, fnames,
                       device="cuda", return_planes: bool = False):
    """Encode (1, 3, H, W) images to incremental-mode container files.
    Returns the file sizes (and the (N, npart, G, h, w) symbol planes
    with ``return_planes``)."""
    dev = resolve_device(device)
    check_model(model, dev)
    pin_numerics()
    assert len(images) == len(fnames)
    sizes, planes = [], []
    for x, fn in zip(images, fnames):
        plane = encode_latents_plane(
            model, torch.as_tensor(x).to(dev, torch.float32), geom)[0]
        _, _, h, w = plane.shape
        codec = get_incremental_codec(model.cfg, geom, h, w, dev).prepare(
            model.ent)
        sizes.append(codec.encode(plane, fn))
        planes.append(plane)
    if return_planes:
        return sizes, torch.stack(planes).cpu().numpy()
    return sizes


@torch.no_grad()
def incr_decode_images(model: CMPNet, geom: Geometry, fnames,
                       image_hw=(512, 1024), device="cuda",
                       return_planes: bool = False):
    """Decode incremental-mode container files -> (N, 3, H, W) float32
    images on the device (and the symbol planes with ``return_planes``)."""
    dev = resolve_device(device)
    check_model(model, dev)
    pin_numerics()
    H, W = image_hw
    h, w = H // geom.npart // 8, W // 8
    codec = get_incremental_codec(model.cfg, geom, h, w, dev).prepare(
        model.ent)
    planes = np.stack([codec.decode(fn) for fn in fnames])
    hcode = torch.as_tensor(planes, device=dev).reshape(
        -1, model.cfg.ngroup, h, w)
    rec = decode_image_from_latents(model, hcode, geom)
    return (rec, planes) if return_planes else rec
