"""Scan wavefront codec: the flagship codec's entropy coding, step by step.

The port of the JAX package's ``codec/wavefront_scan.py``
(``ScanWavefrontCodec`` in two profiles, named by ``window_mode`` as there).
``"window"`` (the default) is the JAX gather and kernel window modes in
one: ``window`` takes the plain gather for a CPU tensor and the CUDA
kernel, bit-equal to it, for a CUDA tensor, and a batched fp32 matmul does
the conv. ``"fused"`` is the JAX fused mode: one call per layer-step,
``fused`` (codec/fused_kernel.py), assembles the window and runs the conv
in one CUDA kernel on the card and in its plain version on the CPU. The
two profiles sum the conv in different orders, so their streams carry
their own profile bits and decode only on their own profile. A latent
symbol at (global row i, column j, group g) is coded at wavefront step
z = i + j + g. Every step runs the causal entropy network on the new
frontier only: for each of its 12 layers a skew window is read out of that
layer's activation buffer (codec/window_kernel.py), the sheared 9x5
convolution of the window turns it into the frontier cells, and the cells
are deposited back; the last layer's GMM parameters become integer CDF rows
(ops/gmm_table.py). Encode feeds the known symbols in (teacher forcing)
and collects each symbol's coder range; decode runs the identical step
program and decodes each step's symbols on the device
(codec/device_ac.py) over L interleaved arithmetic-coder lanes. Encode and
decode therefore launch the same kernels on the same shapes in the same
order, which is what makes their CDF rows, and so the streams, agree.

Layer buffers are flat channel-last and subnet-stacked, (B, Sbuf, CC) with
CC = 3*G*cpn (or G for the input plane), with row margins so every window
run is in bounds, and one trailing row that absorbs the writes of cells
outside the valid region. Where the JAX package runs a ``lax.scan``, this
is one Python loop over the steps; nothing in it waits for the device
except the per-image copy of the results at the end.

Stream format: symbol i of step z goes to lane i % L (coding order per
codec/wavefront.py). Lane sizes are bounded by 16 bits/symbol + 16.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pseudocylindrical_convolution_torch.codec import container, device_ac
from pseudocylindrical_convolution_torch.codec.coder_bridge import (
    encode_lanes)
from pseudocylindrical_convolution_torch.codec.fused_kernel import fused
from pseudocylindrical_convolution_torch.codec.pipeline import (
    BIAS, NSTEP, TOTAL, decode_image_from_latents, encode_latents_plane)
from pseudocylindrical_convolution_torch.codec.wavefront import (
    wavefront_schedule)
from pseudocylindrical_convolution_torch.codec.window_kernel import (
    build_window_tables, window)
from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, CMPNetConfig)
from pseudocylindrical_convolution_torch.models.entropy import (
    stack_step_weights)
from pseudocylindrical_convolution_torch.ops.gmm_table import gmm_cdf_table
from pseudocylindrical_convolution_torch.utils.device import (
    check_model, pin_numerics, resolve_device)


def _shear_kernel(w: torch.Tensor) -> torch.Tensor:
    """(..., 5, 5) -> (..., 9, 5): K[..., dt, di] = W[..., di, dt - di]
    for 0 <= dt - di <= 4, else 0."""
    cols = [F.pad(w[..., di, :], (di, 4 - di)) for di in range(5)]
    return torch.stack(cols, dim=-1)


def bias_prelu(cells: torch.Tensor, layer: dict) -> torch.Tensor:
    """A layer's epilogue on fp32 cells (..., 3*G*n): bias, then PReLU
    where the layer has one."""
    out = cells + layer["b"]
    if layer["a"] is not None:
        out = torch.where(out >= 0, out, layer["a"] * out)
    return out


def conv_taps(win: torch.Tensor, nb: int) -> torch.Tensor:
    """The window profile's matmul operand: each group's 9x5 taps of the
    window (B, npart, h+4, T, CC), gathered once in fp32 ->
    (G*nb, B*npart*h, 45*CC/nb), batch (u = G-1-group, subnet chunk)."""
    B, npart, hp4, T, CC = win.shape
    h, G = hp4 - 4, T - 8
    x = win.float().contiguous()
    s = x.stride()
    # taps[b, p, u, r, dt, di, c] = window[b, p, r+di, u+dt, c]
    taps = x.as_strided((B, npart, G, h, 9, 5, nb, CC // nb),
                        (s[0], s[1], s[3], s[2], s[3], s[2], CC // nb, 1))
    return taps.permute(2, 6, 0, 1, 3, 4, 5, 7).reshape(
        G * nb, B * npart * h, -1)


WINDOW_MODES = ("window", "fused")


class ScanWavefrontCodec:
    """Batched step-by-step wavefront encoder/decoder for one latent
    geometry; B is part of the stream profile (a stream decodes in any
    slot of a B-image codec)."""

    def __init__(self, cfg: CMPNetConfig, geom: Geometry, h: int, w: int,
                 batch: int = 1, lanes: int = 64, cpn: int = 3,
                 num_gaussian: int = 3, dtype=torch.bfloat16,
                 device="cuda", window_mode: str = "window"):
        if window_mode not in WINDOW_MODES:
            raise ValueError(f"window_mode {window_mode!r} is not one of "
                             f"{WINDOW_MODES}")
        self.window_mode = window_mode
        self.device = resolve_device(device)
        pin_numerics()
        self.cfg, self.geom, self.h, self.w = cfg, geom, h, w
        self.B, self.L = batch, lanes
        self.dtype = dtype
        self.cpn, self.ng = cpn, num_gaussian
        G = cfg.ngroup
        npart = geom.npart
        self.G, self.npart = G, npart
        self.h_out = h * npart
        self.P = npart * G * h * w                   # symbol plane size

        order, counts, nsteps = wavefront_schedule(geom, h, w, G)
        self.counts, self.nsteps = counts, nsteps
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)
        self.nsym = int(self.offsets[-1])
        self.tabs = build_window_tables(geom, h, w, G, nsteps, dtype,
                                        self.device)
        self.Sbuf = self.tabs.Sbuf
        M1 = self.tabs.row_off

        i, j, g = (order[:, k].astype(np.int64) for k in range(3))
        b, r = i // h, i % h
        dev = self.device

        def dt(a):
            return torch.tensor(np.ascontiguousarray(a), dtype=torch.int64,
                                device=dev)

        self._grid = dt(g * self.h_out + i)                 # CDF grid row
        self._plane = dt(((b * G + g) * h + r) * w + j)     # (npart,G,h,w)
        self._in0 = dt((M1 + (b * h + r) * w + j) * G + g)  # input buffer
        # per step, the CDF grid rows padded to whole lane rounds (the
        # padding repeats a real row; its lanes are inactive)
        self.rounds = (counts + lanes - 1) // lanes
        pad_grid = np.zeros(int(self.rounds.sum()) * lanes, np.int64)
        self.round_off = np.concatenate([[0], np.cumsum(self.rounds)]) * lanes
        gnp = (g * self.h_out + i)
        for z in range(nsteps):
            o, n = int(self.offsets[z]), int(counts[z])
            pad_grid[self.round_off[z]:self.round_off[z] + n] = gnp[o:o + n]
        self._grid_pad = dt(pad_grid)
        self._active = torch.arange(lanes, device=dev)[None, :] < torch.arange(
            lanes + 1, device=dev)[:, None]                # (L+1, L)

        # deposit: channel c of a (B, npart, h, CC3) cell block lands at
        # column j = z - group(c) - (h*b + r), valid while 0 <= j < wl[b]
        CC3 = 3 * G * cpn
        grp = (np.arange(CC3) % (G * cpn)) // cpn
        bb = np.arange(npart)[:, None, None]
        rr = np.arange(h)[None, :, None]
        lo = grp[None, None, :] + h * bb + rr                # (np, h, CC3)
        wl = np.asarray(geom.hindex(self.h_out, w), np.int64)
        self._dep_lo = dt(lo)
        self._dep_hi = dt(lo + wl[:, None, None])
        self._dep_base = dt((M1 + (bb * h + rr) * w - lo) * CC3
                            + np.arange(CC3)[None, None, :])
        self._dep_trash = dt((self.Sbuf - 1) * CC3
                             + np.broadcast_to(np.arange(CC3), lo.shape))

        lane_of_m = np.concatenate([np.arange(int(n)) % lanes
                                    for n in counts]).astype(np.int64)
        self.lane_counts = np.bincount(lane_of_m, minlength=lanes).astype(
            np.int64)
        self.lane_perm = np.argsort(lane_of_m, kind="stable")
        self.lane_sym_off = np.concatenate([[0], np.cumsum(self.lane_counts)])
        # static worst-case lane sizes: <= 16 bits/sym + 16, byte padding
        self.lane_words_max = (self.lane_counts * 16 + 16 + 31) // 32
        self.word_off_1 = np.concatenate(
            [[0], np.cumsum(self.lane_words_max)])[:-1].astype(np.int64)
        self.NW = int(self.lane_words_max.sum())     # words per image
        self._weights = None
        self._prepared_src = None

    # ------------------------------------------------------------------
    @property
    def profile_flags(self) -> int:
        return container.FLAG_BF16 if self.dtype == torch.bfloat16 else 0

    @property
    def profile_flags2(self) -> int:
        if self.window_mode == "fused":
            return container.FLAG2_TORCH | container.FLAG2_TORCH_FUSED
        return container.FLAG2_TORCH

    @torch.no_grad()
    def prepare(self, ent) -> "ScanWavefrontCodec":
        """Mask, stack and shear the entropy weights into one conv operand
        per layer.

        ent: ``CMPNet.ent``. Output group g of a layer reads the 9x5 taps
        of window slices [G-1-g, G+8-g) (the sheared kernel
        K[dt, di] = W[di, dt-di]). The values are the buffer dtype's, so
        with bf16 buffers every product with the upcast window is exact and
        only the fp32 sums round.

        Window profile, the batched matmul's operand "k": batch u = G-1-g
        holds group g's kernel as (45*cin, n) over (dt, di, cin), held in
        fp32: per subnet for the hidden layers (cin = G*cpn, n = cpn), all
        three subnets at once for the input plane (cin = G, n = 3*cpn).
        Fused profile, the fused kernel's operand "kf": (3*G, 45*cin, cpg)
        in the buffer dtype, batch (subnet, group), as the kernel reads
        it."""
        if self._prepared_src is ent:
            return self
        G = self.G
        self._weights = []
        for li, lay in enumerate(stack_step_weights(ent, G, self.cpn,
                                                    self.ng)):
            wt = lay["w"].to(self.device, torch.float32)
            _, _, cpg, cin, _, _ = wt.shape       # (3, G, cpg, cin, 5, 5)
            k = _shear_kernel(wt).to(self.dtype)   # (3, G, cpg, cin, 9, 5)
            entry = {}
            if self.window_mode == "fused":
                entry["kf"] = k.permute(0, 1, 4, 5, 3, 2).reshape(
                    3 * G, 45 * cin, cpg).contiguous()
            else:
                k = k.float().flip(1)                     # group -> u
                if li == 0:
                    k = k.permute(1, 4, 5, 3, 0, 2).reshape(G, 45 * cin,
                                                            3 * cpg)
                else:
                    k = k.permute(1, 0, 4, 5, 3, 2).reshape(3 * G, 45 * cin,
                                                            cpg)
                entry["k"] = k.contiguous()
            self._weights.append({
                **entry,
                "b": lay["b"].reshape(-1).to(self.device, torch.float32),
                "a": None if lay["a"] is None else
                lay["a"].reshape(-1).to(self.device, torch.float32)})
        self._prepared_src = ent
        return self

    # ------------------------------------------------------------------
    def _conv_cells(self, win: torch.Tensor, layer: dict) -> torch.Tensor:
        """Sheared conv of one layer's window -> fp32 frontier cells
        (B, npart, h, 3*G*n) after bias and PReLU, channels (subnet,
        group, n).

        The JAX package runs a conv over every window slice and keeps one
        output slice per group (conv_chunks trims that G-fold excess);
        here each group's taps are gathered once and contracted in one
        batched fp32 matmul, which computes only the kept slice."""
        G, h, B, npart = self.G, self.h, self.B, self.npart
        k = layer["k"]
        nb = k.shape[0] // G                # matmuls per group: 3 or 1
        out = torch.bmm(conv_taps(win, nb), k).reshape(
            G, nb, B, npart, h, -1).flip(0)
        if nb == 3:                         # (u, s, b, p, r, n)
            out = out.permute(2, 3, 4, 1, 0, 5)
        else:                               # (u, 1, b, p, r, (s, n))
            out = out.reshape(G, B, npart, h, 3, -1).permute(1, 2, 3, 4, 0,
                                                             5)
        return bias_prelu(out.reshape(B, npart, h, -1), layer)

    def _frontier(self, buf, z, layer):
        if self.window_mode == "fused":
            return bias_prelu(fused(buf, z, self.tabs, layer["kf"]), layer)
        return self._conv_cells(window(buf, z, self.tabs), layer)

    def _deposit_index(self, z: int) -> torch.Tensor:
        """Flat hidden-buffer targets of step z's frontier cells, the same
        for all 11 hidden layers; cells outside the valid region target the
        trash row."""
        valid = (self._dep_lo <= z) & (z < self._dep_hi)
        step = z * self._dep_lo.shape[-1]
        return torch.where(valid, self._dep_base + step,
                           self._dep_trash).reshape(-1)

    @staticmethod
    def _deposit(buf: torch.Tensor, cells: torch.Tensor, idx: torch.Tensor):
        """Write frontier cells into a hidden-layer buffer. The targets are
        still zero (each cell is written once, at its own step), so this
        assignment gives the same bits as the JAX package's masked add."""
        B = buf.shape[0]
        buf.view(B, -1)[:, idx] = cells.to(buf.dtype).reshape(B, -1)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run(self, teacher: torch.Tensor | None = None,
            streams: tuple | None = None, tables_out: list | None = None):
        """Run the step program once over all nsteps.

        Teacher mode (encode): ``teacher`` (B, P) int64 symbol planes.
        Decode mode: ``streams`` = (words (B*NW,), word_off (B, L),
        nbits (B, L)) int64 device tensors. Returns (symbol planes (B, P)
        int64, packed coder ranges (B, nsym) int64), on the device.
        ``tables_out``, if a list, receives each step's CDF rows (B, n, 9)
        in coding order."""
        if self._weights is None:
            raise RuntimeError("call prepare(model.ent) first")
        B, L, G, dev = self.B, self.L, self.G, self.device
        C3 = 3 * G * self.cpn
        bufs = [torch.zeros((B, self.Sbuf, G), dtype=self.dtype, device=dev)]
        bufs += [torch.zeros((B, self.Sbuf, C3), dtype=self.dtype,
                             device=dev) for _ in range(11)]
        out_plane = torch.zeros((B, self.P), dtype=torch.int64, device=dev)
        packed = torch.zeros((B, self.nsym), dtype=torch.int64, device=dev)
        decode = teacher is None
        if decode:
            words = streams[0]
            ac = device_ac.init_state(words, streams[1], streams[2])
        wts = self._weights
        for z in range(self.nsteps):
            dep = self._deposit_index(z)
            y0 = self._frontier(bufs[0], z, wts[0])
            self._deposit(bufs[1], y0, dep)
            ycells = y0
            for blk in range(5):
                li = 1 + 2 * blk
                c1 = self._frontier(bufs[li], z, wts[li])
                self._deposit(bufs[li + 1], c1, dep)
                c2 = self._frontier(bufs[li + 1], z, wts[li + 1])
                ycells = ycells + c2
                self._deposit(bufs[li + 2], ycells, dep)
            out = self._frontier(bufs[11], z, wts[11])
            # CDF grid (B, G*h_out, 9): grid row = g*h_out + (b*h + r);
            # out channels are subnet-major (s, g, k)
            prm = out.reshape(B, self.npart, self.h, 3, G, self.ng).permute(
                3, 0, 4, 1, 2, 5).reshape(3, B, G * self.h_out, self.ng)
            tb = gmm_cdf_table(prm[0], prm[1], prm[2], NSTEP, BIAS, TOTAL)

            o, n = int(self.offsets[z]), int(self.counts[z])
            if n == 0:
                continue
            plane_sel = self._plane[o:o + n]
            if decode:
                nr = int(self.rounds[z])
                ro = int(self.round_off[z])
                cdf = tb[:, self._grid_pad[ro:ro + nr * L]].long()
                sys = []
                for rr in range(nr):
                    act = self._active[min(L, n - rr * L)].expand(B, L)
                    ac, s = device_ac.decode_symbols(
                        ac, words, cdf[:, rr * L:(rr + 1) * L], act)
                    sys.append(s)
                sy = torch.cat(sys, dim=1)[:, :n]
                cdf = cdf[:, :n]
            else:
                cdf = tb[:, self._grid[o:o + n]].long()
                sy = teacher[:, plane_sel]
            if tables_out is not None:
                tables_out.append(cdf)
            low = torch.gather(cdf, 2, sy[..., None])[..., 0]
            high = torch.gather(cdf, 2, sy[..., None] + 1)[..., 0]
            packed[:, o:o + n] = low | ((high - 1) << 16)
            out_plane[:, plane_sel] = sy
            bufs[0].view(B, -1)[:, self._in0[o:o + n]] = (
                sy.float() - BIAS).to(self.dtype)
        return out_plane, packed

    # ------------------------------------------------------------------
    def encode_planes(self, planes) -> list:
        """planes: (B, npart, G, h, w) integer symbols (tensor or numpy).
        Returns B (payload bytes, lane_nbytes) pairs."""
        teacher = torch.as_tensor(planes).to(self.device, torch.int64)
        assert teacher.shape == (self.B, self.npart, self.G, self.h, self.w)
        _, packed = self.run(teacher=teacher.reshape(self.B, self.P))
        return self._lanes(packed.cpu().numpy())

    def _lanes(self, packed: np.ndarray) -> list:
        out = []
        for b in range(packed.shape[0]):
            payload, lane_nbytes = encode_lanes(
                packed[b][self.lane_perm].astype(np.uint32),
                self.lane_sym_off, TOTAL)
            assert (lane_nbytes.astype(np.int64) * 8
                    <= self.lane_counts * 16 + 16).all(), \
                "lane exceeded the static AC size bound"
            out.append((payload, lane_nbytes))
        return out

    def write_files(self, streams: list, fnames) -> list:
        """Write (payload, lane_nbytes) pairs as container files."""
        return [container.write_stream(
            fn, container.MODE_SCAN, self.npart, self.cfg.valid_dim, self.h,
            self.w, payload, lanes=self.L, batch=self.B,
            lane_nbytes=lane_nbytes, flags=self.profile_flags,
            flags2=self.profile_flags2)
            for (payload, lane_nbytes), fn in zip(streams, fnames)]

    def check_header(self, hdr: dict, fname: str) -> None:
        container.check_stream(hdr, fname, container.MODE_SCAN, self.npart,
                               self.cfg.valid_dim, self.h, self.w)
        if hdr["lanes"] != self.L or hdr["batch"] != self.B:
            raise ValueError(
                f"{fname}: stream was encoded for a (batch={hdr['batch']}, "
                f"lanes={hdr['lanes']}) codec, decoder is (batch={self.B}, "
                f"lanes={self.L})")
        want = (self.profile_flags, self.profile_flags2)
        got = (hdr["flags"], hdr["flags2"])
        if got != want:
            raise ValueError(f"{fname}: stream profile flags {got} do not "
                             f"match this decoder's profile {want}")

    def encode_files(self, planes, fnames) -> list:
        """Encode (B, npart, G, h, w) symbol planes to container files;
        ``fnames`` may be shorter than B (padding slots are dropped).
        Returns the file sizes."""
        return self.write_files(self.encode_planes(planes)[:len(fnames)],
                                fnames)

    def decode_files(self, fnames) -> np.ndarray:
        """Decode <= B container files written by this codec's profile ->
        (len(fnames), npart, G, h, w) int64 symbol planes."""
        streams = []
        for fn in fnames:
            hdr = container.read_stream(fn)
            self.check_header(hdr, fn)
            streams.append((hdr["payload"], hdr["lane_nbytes"]))
        return self.decode_streams(streams)

    def decode_streams_device(self, streams: list) -> torch.Tensor:
        """streams: <= B (payload bytes, lane_nbytes) pairs -> (B, P) int64
        symbol planes on the device (unused slots decode zeros)."""
        B, L, NW = self.B, self.L, self.NW
        assert len(streams) <= B
        words = np.zeros((B, NW), np.int64)
        nbits = np.zeros((B, L), np.int64)
        for b, (payload, lane_nbytes) in enumerate(streams):
            pos = 0
            for ln, nb in enumerate(np.asarray(lane_nbytes, np.int64)):
                nb = int(nb)
                wb = np.zeros(((nb + 3) // 4) * 4, np.uint8)
                wb[:nb] = np.frombuffer(payload, np.uint8, count=nb,
                                        offset=pos)
                pos += nb
                w32 = wb.reshape(-1, 4).astype(np.int64)
                off = int(self.word_off_1[ln])
                words[b, off:off + w32.shape[0]] = (
                    (w32[:, 0] << 24) | (w32[:, 1] << 16)
                    | (w32[:, 2] << 8) | w32[:, 3])
                nbits[b, ln] = nb * 8
        word_off = self.word_off_1[None, :] + np.arange(B)[:, None] * NW
        dev = self.device
        plane, _ = self.run(streams=(
            torch.tensor(words.reshape(-1), device=dev),
            torch.tensor(word_off, device=dev),
            torch.tensor(nbits, device=dev)))
        return plane

    def decode_streams(self, streams: list) -> np.ndarray:
        """-> (len(streams), npart, G, h, w) int64 numpy symbol planes."""
        plane = self.decode_streams_device(streams)[:len(streams)]
        return plane.cpu().numpy().reshape(len(streams), self.npart, self.G,
                                           self.h, self.w)


# ---------------------------------------------------------------------------
# Image-level API (the CLI's codec)
# ---------------------------------------------------------------------------

_CODEC_CACHE: dict = {}


def auto_lanes(geom: Geometry, h: int, w: int, G: int) -> int:
    """AC lanes: 256 at real image sizes, scaled down (floor 64) for tiny
    geometries so their streams do not pay 256 lane terminations."""
    _, counts, _ = wavefront_schedule(geom, h, w, G)
    nsym = float(counts.sum())
    cap = 1 << max(6, int(np.log2(max(1.0, nsym / 1000.0))))
    return int(min(256, cap))


def get_scan_codec(cfg: CMPNetConfig, geom: Geometry, h: int, w: int,
                   batch: int, lanes: int, dtype=torch.bfloat16,
                   device="cuda", window_mode: str = "window"
                   ) -> ScanWavefrontCodec:
    dev = resolve_device(device)
    key = (cfg, geom, h, w, batch, lanes, dtype, str(dev), window_mode)
    codec = _CODEC_CACHE.get(key)
    if codec is None:
        codec = ScanWavefrontCodec(cfg, geom, h, w, batch=batch, lanes=lanes,
                                   dtype=dtype, device=dev,
                                   window_mode=window_mode)
        _CODEC_CACHE[key] = codec
    return codec


@torch.no_grad()
def scan_encode_images(model: CMPNet, images, geom: Geometry, fnames,
                       batch: int = 1, lanes: int | None = None,
                       device="cuda", return_planes: bool = False):
    """Encode (1, 3, H, W) images (values in [0, 1]) to scan-mode container
    files. Returns the file sizes (and the (N, npart, G, h, w) symbol
    planes with ``return_planes``)."""
    dev = resolve_device(device)
    check_model(model, dev)
    pin_numerics()
    cfg = model.cfg
    assert len(images) == len(fnames)
    planes = [encode_latents_plane(
        model, torch.as_tensor(x).to(dev, torch.float32), geom)[0]
        for x in images]                                # (npart, G, h, w)
    h, w = planes[0].shape[2:]
    if lanes is None:
        lanes = auto_lanes(geom, h, w, cfg.ngroup)
    codec = get_scan_codec(cfg, geom, h, w, batch, lanes,
                           device=dev).prepare(model.ent)
    sizes = []
    for o in range(0, len(planes), batch):
        chunk = planes[o:o + batch]
        full = torch.stack(chunk + [chunk[-1]] * (batch - len(chunk)))
        sizes += codec.encode_files(full, fnames[o:o + batch])
    if return_planes:
        return sizes, torch.stack(planes).cpu().numpy()
    return sizes


@torch.no_grad()
def scan_decode_images(model: CMPNet, geom: Geometry, fnames,
                       image_hw=(512, 1024), device="cuda",
                       return_planes: bool = False):
    """Decode scan-mode container files -> (N, 3, H, W) float32 images on
    the device (and the (N, npart, G, h, w) symbol planes with
    ``return_planes``). The codec's profile (buffer dtype, window or fused)
    is the one the first stream's header names; every stream must match
    it."""
    dev = resolve_device(device)
    check_model(model, dev)
    pin_numerics()
    cfg = model.cfg
    H, W = image_hw
    h, w = H // geom.npart // 8, W // 8
    hdrs = [container.read_stream(fn) for fn in fnames]
    hdr0 = hdrs[0]
    dtype = (torch.bfloat16 if hdr0["flags"] & container.FLAG_BF16
             else torch.float32)
    window_mode = ("fused" if hdr0["flags2"] & container.FLAG2_TORCH_FUSED
                   else "window")
    codec = get_scan_codec(
        cfg, geom, h, w, int(hdr0["batch"]), int(hdr0["lanes"]),
        dtype=dtype, device=dev, window_mode=window_mode).prepare(model.ent)
    recs, planes = [], []
    for o in range(0, len(fnames), codec.B):
        chunk = list(zip(hdrs[o:o + codec.B], fnames[o:o + codec.B]))
        for hdr, fn in chunk:
            codec.check_header(hdr, fn)
        plane = codec.decode_streams_device(
            [(hdr["payload"], hdr["lane_nbytes"]) for hdr, _ in chunk])
        plane = plane[:len(chunk)]
        planes.append(plane)
        recs.append(decode_image_from_latents(
            model, plane.reshape(-1, cfg.ngroup, h, w), geom))
    rec = torch.cat(recs)
    if return_planes:
        return rec, torch.cat(planes).cpu().numpy().reshape(
            len(fnames), geom.npart, cfg.ngroup, h, w)
    return rec
