"""The image <-> latent halves of the codec, and the dense codec mode.

The port of the JAX package's ``codec/pipeline.py``. The transform-side
programs (``encode_latents_plane``, ``decode_image_from_latents``) serve
every mode; the rest is the dense mode (``MODE_DENSE`` streams):

  * ENCODE runs the causal entropy network once on the whole symbol
    plane, builds every symbol's CDF row and codes them in one host call.
  * DECODE steps the wavefront: at step z it runs the same network on
    the partial plane (decoded symbols, zeros elsewhere), builds the CDF
    rows of step z's symbols, decodes them, and writes them into the
    plane.

Bit-exactness rests on the network giving step z's cells the same bits
on the partial plane as on the full one. The causal masks and pads make
every future value enter a sum as an exact +-0, and models/entropy.py
computes each layer as a gather, im2col and an fp32 matmul whose sum
order does not depend on the values (never a library convolution, whose
algorithm may transform whole tiles). Both sides run the network through
one function on the same (1*npart, G, h, w) plane, and both build the
CDF rows through one function, ``_step_rows``, on the same maxlen-row
window of each step, so no reduction kernel sees a different row count
on the two sides. Decode runs one B=1 network per stream; so does
encode, whatever the number of images.
"""

from __future__ import annotations

import numpy as np
import torch

from pseudocylindrical_convolution_torch.codec import container
from pseudocylindrical_convolution_torch.codec.coder_bridge import Coder
from pseudocylindrical_convolution_torch.codec.wavefront import (
    symbol_gather_index, wavefront_schedule)
from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, CMPNetConfig, cmpnet_decode_latents, cmpnet_encode_latents)
from pseudocylindrical_convolution_torch.models.entropy import (
    _fill, entropy_raw_cm, fused_weights)
from pseudocylindrical_convolution_torch.ops.gmm_table import gmm_cdf_table
from pseudocylindrical_convolution_torch.utils.device import (
    check_model, pin_numerics, resolve_device)

NSTEP = 8          # quantizer bins / AC symbols
BIAS = 3.5
TOTAL = 65536


@torch.no_grad()
def encode_latents_plane(model: CMPNet, x: torch.Tensor,
                         geom: Geometry) -> torch.Tensor:
    """Image batch (B, 3, H, W) -> integer symbol planes
    (B, npart, G, h, w) int64."""
    hcode = cmpnet_encode_latents(model, x, geom)
    _, G, h, w = hcode.shape
    return hcode.reshape(x.shape[0], geom.npart, G, h, w)


@torch.no_grad()
def decode_image_from_latents(model: CMPNet, hcode: torch.Tensor,
                              geom: Geometry) -> torch.Tensor:
    """hcode (B*npart, G, h, w) integer symbols -> images (B, 3, H, W)."""
    return cmpnet_decode_latents(model, hcode, geom)


# ---------------------------------------------------------------------------
# Dense mode: tables
# ---------------------------------------------------------------------------


class _Schedule:
    """The static coding order of one latent geometry, on a device."""

    def __init__(self, geom: Geometry, h: int, w: int, G: int, dev):
        _, counts, nsteps = wavefront_schedule(geom, h, w, G)
        self.counts, self.nsteps = counts, nsteps
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)
        self.maxlen = int(counts.max())
        self.flat = symbol_gather_index(geom, h, w, G).astype(np.int64)
        # padded so every step's maxlen window is in range (JAX pads the
        # same way, with row 0)
        self.flat_pad = torch.tensor(
            np.concatenate([self.flat, np.zeros(self.maxlen, np.int64)]),
            device=dev)


def _raw_rows(layers: list, plane: torch.Tensor,
              geom: Geometry) -> torch.Tensor:
    """One image's biased symbol plane (npart, G, h, w) -> raw GMM
    parameters (3, npart*G*h*w, ng), rows in plane order."""
    npart, G, h, w = plane.shape
    x = plane.float().permute(1, 0, 2, 3).reshape(G, 1, -1)
    out = entropy_raw_cm(layers, _fill(x, geom, h, w), geom, h, w)
    ng = out.shape[1] // G
    return out.reshape(3, G, ng, npart, h, w).permute(0, 3, 1, 4, 5, 2
                                                      ).reshape(3, -1, ng)


def _step_rows(raw: torch.Tensor, sched: _Schedule, z: int) -> torch.Tensor:
    """CDF rows (maxlen, NSTEP+1) int32 of step z's window in coding order
    (rows past the step's count belong to later steps). Encoder and
    decoder both build their rows here, on the same shape."""
    o = int(sched.offsets[z])
    r = raw[:, sched.flat_pad[o:o + sched.maxlen]]
    return gmm_cdf_table(r[0], r[1], r[2], NSTEP, BIAS, TOTAL)


def _table_body(layers: list, planes: torch.Tensor, geom: Geometry,
                sched: _Schedule) -> torch.Tensor:
    """Biased symbol planes (B, npart, G, h, w), holding (symbol - BIAS)
    at known cells and 0 elsewhere -> CDF tables (B, nsym, NSTEP+1)
    int32 in coding order, one B=1 network per image."""
    out = []
    for plane in planes:
        raw = _raw_rows(layers, plane, geom)
        out.append(torch.cat([
            _step_rows(raw, sched, z)[:int(n)]
            for z, n in enumerate(sched.counts)]))
    return torch.stack(out)


@torch.no_grad()
def _encode_latents_plane(model: CMPNet, x: torch.Tensor, geom: Geometry,
                          sched: _Schedule):
    """Images -> (symbol planes (B, npart, G, h, w) int64, biased planes
    (float32), symbols in coding order (B, nsym) int64)."""
    hcode = encode_latents_plane(model, x, geom)
    plane = hcode.float() - BIAS
    syms = hcode.reshape(hcode.shape[0], -1)[:, sched.flat_pad[
        :sched.flat.shape[0]]]
    return hcode, plane, syms


def _gather_ranges_packed(tables: torch.Tensor,
                          syms: torch.Tensor) -> torch.Tensor:
    """(B, n, NSTEP+1), (B, n) -> (B, n) int64 words low | ((high-1) << 16);
    the total is always TOTAL after the monotonic repair."""
    t = tables.long()
    low = torch.gather(t, 2, syms[..., None])[..., 0]
    high = torch.gather(t, 2, syms[..., None] + 1)[..., 0]
    return low | ((high - 1) << 16)


def _write_dense(fname: str, packed_row: np.ndarray, geom: Geometry,
                 cfg: CMPNetConfig, h: int, w: int) -> int:
    coder = Coder()
    coder.start_encoder()
    coder.encode_packed(packed_row.astype(np.uint32), TOTAL)
    return container.write_stream(fname, container.MODE_DENSE, geom.npart,
                                  cfg.valid_dim, h, w,
                                  coder.end_encoder_buf())


# ---------------------------------------------------------------------------
# Dense mode: encode
# ---------------------------------------------------------------------------


@torch.no_grad()
def encode_images(model: CMPNet, images, geom: Geometry, fnames,
                  device="cuda", return_planes: bool = False):
    """Encode (1, 3, H, W) images (values in [0, 1]) to dense-mode
    container files, one B=1 program each. Returns the file sizes (and
    the (N, npart, G, h, w) symbol planes with ``return_planes``)."""
    dev = resolve_device(device)
    check_model(model, dev)
    pin_numerics()
    assert len(images) == len(fnames), "one bitstream file per image"
    layers = fused_weights(model.ent, model.cfg.ngroup)
    sizes, planes, sched = [], [], None
    for x, fn in zip(images, fnames):
        x = torch.as_tensor(x).to(dev, torch.float32)
        assert x.shape[0] == 1
        if sched is None:
            h, w = x.shape[2] // geom.npart // 8, x.shape[3] // 8
            sched = _Schedule(geom, h, w, model.cfg.ngroup, dev)
        hcode, plane, syms = _encode_latents_plane(model, x, geom, sched)
        tables = _table_body(layers, plane, geom, sched)
        packed = _gather_ranges_packed(tables, syms).cpu().numpy()
        sizes.append(_write_dense(fn, packed[0], geom, model.cfg,
                                  *hcode.shape[3:]))
        planes.append(hcode[0])
    if return_planes:
        return sizes, torch.stack(planes).cpu().numpy()
    return sizes


def encode_image(model: CMPNet, x, geom: Geometry, fnames, device="cuda"):
    """Encode a (B, 3, H, W) batch to per-image dense-mode files.

    fnames: str (B must be 1) or a list of B names; returns the byte
    size(s). A batch is coded as B single-image programs: the decoder
    always runs the B=1 network, and the encoder must run the same one."""
    single = isinstance(fnames, str)
    names = [fnames] if single else list(fnames)
    assert x.shape[0] == len(names), "one bitstream file per image"
    sizes = encode_images(model, [x[b:b + 1] for b in range(x.shape[0])],
                          geom, names, device=device)
    return sizes[0] if single else sizes


@torch.no_grad()
def _encode_tables(model: CMPNet, x, geom: Geometry, device="cuda"):
    """One image -> (symbols (nsym,), CDF tables (nsym, NSTEP+1), latent
    planes (1, npart, G, h, w)), on the device."""
    dev = resolve_device(device)
    check_model(model, dev)
    pin_numerics()
    x = torch.as_tensor(x).to(dev, torch.float32)
    sched = _Schedule(geom, x.shape[2] // geom.npart // 8, x.shape[3] // 8,
                      model.cfg.ngroup, dev)
    hcode, plane, syms = _encode_latents_plane(model, x, geom, sched)
    tables = _table_body(fused_weights(model.ent, model.cfg.ngroup), plane,
                         geom, sched)
    return syms[0], tables[0], hcode


# ---------------------------------------------------------------------------
# Dense mode: decode
# ---------------------------------------------------------------------------


def _scatter_prev(plane: torch.Tensor, pos: torch.Tensor,
                  syms: torch.Tensor) -> torch.Tensor:
    """Write decoded symbols into the biased plane at flat positions
    ``pos``; the targets are still 0, so this is the JAX masked add."""
    plane.view(-1)[pos] = syms.float() - BIAS
    return plane


def _decode_step_fused(layers: list, plane: torch.Tensor, prev_pos,
                       prev_syms, z: int, geom: Geometry,
                       sched: _Schedule):
    """One decode step: write step z-1's symbols, run the network on the
    partial plane, build step z's rows. Returns (plane, step_tb
    (maxlen, NSTEP-1) int32): only the interior CDF entries travel (entry
    0 is always 0 and entry NSTEP always TOTAL after the repair)."""
    if prev_pos is not None:
        plane = _scatter_prev(plane, prev_pos, prev_syms)
    raw = _raw_rows(layers, plane, geom)
    return plane, _step_rows(raw, sched, z)[:, 1:NSTEP]


def _unpack_step_tables(tb: np.ndarray) -> np.ndarray:
    """(n, NSTEP-1) interior entries -> (n, NSTEP+1) int32 rows."""
    n = tb.shape[0]
    out = np.empty((n, NSTEP + 1), np.int32)
    out[:, 0] = 0
    out[:, 1:NSTEP] = tb
    out[:, NSTEP] = TOTAL
    return out


@torch.no_grad()
def decode_latents(model: CMPNet, geom: Geometry, h: int, w: int, fnames,
                   device="cuda") -> np.ndarray:
    """Sequential wavefront decode of dense-mode streams, in lockstep.

    fnames: str or list. Returns (npart, G, h, w) int64 symbols for a
    single name, else (B, npart, G, h, w). Each stream runs its own B=1
    network, the program its encoder ran."""
    dev = resolve_device(device)
    check_model(model, dev)
    pin_numerics()
    cfg = model.cfg
    single = isinstance(fnames, str)
    names = [fnames] if single else list(fnames)
    sched = _Schedule(geom, h, w, cfg.ngroup, dev)
    coders = []
    for fn in names:
        hdr = container.read_stream(fn)
        container.check_stream(hdr, fn, container.MODE_DENSE, geom.npart,
                               cfg.valid_dim, h, w)
        c = Coder()
        c.start_decoder_buf(hdr["payload"])
        coders.append(c)
    layers = fused_weights(model.ent, cfg.ngroup)
    B = len(names)
    planes = [torch.zeros((geom.npart, cfg.ngroup, h, w), device=dev)
              for _ in range(B)]
    out = np.zeros((B, sched.flat.shape[0]), np.int64)
    prev = [(None, None)] * B
    for z in range(sched.nsteps):
        n = int(sched.counts[z])
        o = int(sched.offsets[z])
        if n == 0:
            continue
        tbs = []
        for b in range(B):
            planes[b], tb = _decode_step_fused(layers, planes[b], *prev[b],
                                               z, geom, sched)
            tbs.append(tb[:n])
        pos = sched.flat_pad[o:o + n]
        for b in range(B):
            syms = coders[b].decodes(
                _unpack_step_tables(tbs[b].cpu().numpy()), NSTEP, n)
            out[b, o:o + n] = syms
            prev[b] = (pos, torch.as_tensor(syms, device=dev))
    planes = np.zeros((B, geom.npart * cfg.ngroup * h * w), np.int64)
    planes[:, sched.flat] = out
    planes = planes.reshape(B, geom.npart, cfg.ngroup, h, w)
    return planes[0] if single else planes


@torch.no_grad()
def decode_image(model: CMPNet, geom: Geometry, fnames,
                 image_hw=(512, 1024), device="cuda",
                 return_planes: bool = False):
    """Decode dense-mode stream(s) -> (B, 3, H, W) float32 images on the
    device (B=1 for a single name), and the (B, npart, G, h, w) symbol
    planes with ``return_planes``."""
    dev = resolve_device(device)
    H, W = image_hw
    h, w = H // geom.npart // 8, W // 8
    names = [fnames] if isinstance(fnames, str) else list(fnames)
    planes = decode_latents(model, geom, h, w, names, device=dev)
    hcode = torch.as_tensor(planes, device=dev).reshape(
        -1, model.cfg.ngroup, h, w)
    rec = decode_image_from_latents(model, hcode, geom)
    return (rec, planes) if return_planes else rec
