"""The scan codec's skew window: CUDA kernel (csrc/window.cu), plain version.

One layer-step of the scan codec (codec/wavefront_scan.py) reads a skew
window (B, npart, h+4, T, CC), T = G+8, out of the layer buffer
(B, Sbuf, CC) through the causal 2-tap pad tables. This module holds

  * ``window_plain``: the gather through the tables, in torch ops -- the
    CPU path and the kernel's reference;
  * ``window_cuda``: the same window from the CUDA kernel that replaces the
    JAX package's Pallas kernel ``codec/pallas_window.py::_window_kernel``,
    one launch per call;
  * ``window``: the wrapper the codec calls. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises;
  * ``window_from_tables``: the window built in torch from the kernel's own
    tables, position by position as the kernel resolves them; the tests and
    chip_smoke.py hold it to ``window_plain`` bit for bit.

All read the same static tables (``build_window_tables``), built once per
codec geometry. The kernel's element code (csrc/window_common.cuh) and the
wrapper's helpers here (``check_buffer``, ``step_table_ptrs``,
``source_rows``) also serve the fused window+conv kernel
(codec/fused_kernel.py).

Every window element is a copy, one weighted tap rounded once to the
buffer dtype, or (on the 4 vertical-pad rows) the sum of two such taps
rounded once more; a tap whose weight is 0 is +0.0. So the
kernel and the plain version agree bit for bit, which is what lets an
encode and a decode that use the same path agree on every CDF row.

The kernel's decomposition (audited here at table-build time, as in the
JAX package's ``_burst_setup`` and ``_mmpad_tables``):
  * interior row (band b, row r): window position t reads buffer row
    ``starts[b, r] + t`` while 0 <= j0[b, r] + t < wl[b], is +0.0 outside,
    and at ``tpos[b, r, k]`` takes one of <= 6 patch taps (the causal-left
    zeros and the circular wraps): buffer row ``idx6[b, r, k]`` weighted by
    ``wgt6[b, r, k]``;
  * vertical-pad row k, tap q: position t reads column ``colz[b,k,q,t]``
    of the single source row ``pstarts[b,k,q]``, weighted by ``wz``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from pseudocylindrical_convolution_torch.codec.incremental import (
    _static_tables)
from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.utils.build import (
    build_library, find_nvcc)

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launches of the CUDA kernel (one per ``window`` call on a CUDA tensor).
launches = 0
_lib = None
# replicas of the scan codec launch from several host threads
_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class WindowTables:
    """Static window tables of one (geometry, h, w, G, dtype, device).
    Frozen, so the table addresses cached in ``ptrs`` stay those of its
    tensors."""
    G: int
    h: int
    w: int
    npart: int
    T: int
    row_off: int            # buffer-row margin M1 before the plane rows
    Sbuf: int               # buffer rows: M1 + S + M2 + 1 (last: trash)
    wl: torch.Tensor        # (npart,) int32 valid widths
    # gather path (plain version)
    cp_base: torch.Tensor   # (npart, h+4, T) int64: padded col - z
    idx: torch.Tensor       # (2, npart, h+4, w+5) int64 buffer rows
    wgt: torch.Tensor       # (2, npart, h+4, w+5) dtype
    # kernel path, per step z in [0, nsteps)
    starts: torch.Tensor    # (nsteps, npart, h) int32
    j0: torch.Tensor        # (nsteps, npart, h) int32
    tpos: torch.Tensor      # (nsteps, npart, h, 6) int32, -1 = no patch
    colz: torch.Tensor      # (nsteps, npart, 4, 2, T) int32
    wz: torch.Tensor        # (nsteps, npart, 4, 2, T) dtype
    pstarts: torch.Tensor   # (npart, 4, 2) int32
    idx6: torch.Tensor      # (npart, h, 6) int32 patch source rows
    wgt6: torch.Tensor      # (npart, h, 6) dtype patch weights
    # (address, bytes per step; 0 for a static table) of each table the
    # window and fused kernels read, in their argument order
    ptrs: tuple = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        def per_step(t):
            return t.data_ptr(), t.stride(0) * t.element_size()

        def whole(t):
            return t.data_ptr(), 0

        object.__setattr__(self, "ptrs", (
            per_step(self.starts), per_step(self.j0), per_step(self.tpos),
            whole(self.idx6), whole(self.wgt6), whole(self.pstarts),
            per_step(self.colz), per_step(self.wz), whole(self.wl)))


def build_window_tables(geom: Geometry, h: int, w: int, G: int,
                        nsteps: int, dtype: torch.dtype,
                        device) -> WindowTables:
    """Margins, per-step kernel tables and the exactness audits."""
    npart = geom.npart
    T = G + 8
    S = npart * h * w
    idxp, wgtp = _static_tables(geom, h, w)            # (2, np, h+4, w+5)
    wl = np.asarray(geom.hindex(h * npart, w), np.int64)
    b = np.arange(npart)[:, None]
    r = np.arange(h)[None, :]
    # interior row (b, r) at step z reads buffer columns j0 + t,
    # j0 = z - G - 3 - h*b - r; the margins keep every run in bounds
    base = (b * h + r) * w
    j0_z0 = -G - 3 - h * b - r
    M1 = max(0, -int((base + j0_z0).min()))
    M2 = max(0, int((base + j0_z0 + nsteps - 1).max()) + T - S)
    Sbuf = M1 + S + M2 + 1

    # audit: on interior rows every table entry is the identity inside the
    # valid width, a patch column, or weight 0
    cand = np.stack([np.zeros(npart, np.int64), np.ones(npart, np.int64),
                     wl + 2, wl + 3, np.full(npart, w + 2),
                     np.full(npart, w + 3)], axis=1)   # (np, 6) padded cols
    dup = np.zeros((npart, 6), bool)
    for k in range(1, 6):
        dup[:, k] = (cand[:, :k] == cand[:, k:k + 1]).any(axis=1)
    jj = np.arange(w + 5) - 2
    flat = (b * h + r)[..., None] * w + jj
    idx_i, wgt_i = idxp[0][:, 2:h + 2], wgtp[0][:, 2:h + 2]
    inside = (jj[None, :] >= 0) & (jj[None, :] < wl[:, None])
    iscand = np.zeros((npart, w + 5), bool)
    np.put_along_axis(iscand, cand, True, axis=1)
    ok = np.where(inside[:, None], (idx_i == flat) & (wgt_i == 1.0),
                  iscand[:, None] | (wgt_i == 0.0))
    if not ok.all():
        raise ValueError("the causal pad tables of this geometry do not "
                         "decompose into runs + <= 6 patch columns")
    cand_b = np.broadcast_to(cand[:, None, :], (npart, h, 6))
    idx6 = np.take_along_axis(idx_i, cand_b, axis=2) + M1
    wgt6 = np.take_along_axis(wgt_i, cand_b, axis=2)

    # vertical-pad rows: each (band, pad row k, tap) reads ONE plane row
    prow = np.r_[0:2, h + 2:h + 4]
    Rrow = np.zeros((npart, 4, 2), np.int64)
    col = np.zeros((npart, 4, 2, w + 5), np.int64)
    for bb in range(npart):
        for k in range(4):
            for q in range(2):
                ix, wg = idxp[q][bb, prow[k]], wgtp[q][bb, prow[k]]
                live = wg != 0
                if live.any():
                    rows = np.unique(ix[live] // w)
                    if len(rows) != 1:
                        raise ValueError(
                            "a pad tap of this geometry spans several "
                            "source rows")
                    Rrow[bb, k, q] = rows[0]
                    col[bb, k, q, live] = ix[live] - rows[0] * w
    wgt_p = wgtp[:, :, prow].transpose(1, 2, 0, 3)     # (np, 4, 2, w+5)

    t = np.arange(T)
    zs = np.arange(nsteps)[:, None, None]
    j0 = zs - G - 3 - h * b[None] - r[None]            # (nz, np, h)
    starts = M1 + (b * h + r)[None] * w + j0
    tpos = np.where(dup[None, :, None, :], -1,
                    cand[None, :, None, :] - 2 - j0[..., None])
    cp_pad = (-G + 1 - h * np.arange(npart)[:, None] - prow[None, :])
    ccM = (cp_pad[None, :, :, None, None] + zs[..., None, None]
           + t)                                        # (nz, np, 4, 1, T)
    ccM = np.broadcast_to(ccM, (nsteps, npart, 4, 2, T))
    inb = (ccM >= 0) & (ccM <= w + 4)
    ccc = np.clip(ccM, 0, w + 4)
    colz = np.take_along_axis(np.broadcast_to(col, (nsteps,) + col.shape),
                              ccc, axis=4)
    wz = np.where(inb, np.take_along_axis(
        np.broadcast_to(wgt_p, (nsteps,) + wgt_p.shape), ccc, axis=4), 0.0)

    rp = np.arange(h + 4)
    cp_base = (-G + 1 - h * np.arange(npart)[:, None, None]
               + t[None, None, :] - rp[None, :, None])

    def dev(a, dt=torch.int32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    return WindowTables(
        G=G, h=h, w=w, npart=npart, T=T, row_off=M1, Sbuf=Sbuf,
        wl=dev(wl), cp_base=dev(cp_base, torch.int64),
        idx=dev(idxp.astype(np.int64) + M1, torch.int64),
        wgt=dev(wgtp, torch.float32).to(dtype),
        starts=dev(starts), j0=dev(j0), tpos=dev(tpos),
        colz=dev(colz), wz=dev(wz, torch.float32).to(dtype),
        pstarts=dev(M1 + Rrow * w),
        idx6=dev(idx6), wgt6=dev(wgt6, torch.float32).to(dtype))


def _weighted(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """One tap: x * w rounded once to x's dtype; +0.0 where w is 0."""
    wt = wt[..., None]
    return torch.where(wt != 0, x * wt, 0)


def window_plain(buf: torch.Tensor, z: int, tabs: WindowTables
                 ) -> torch.Tensor:
    """Window (B, npart, h+4, T, CC) of ``buf`` (B, Sbuf, CC) at step z,
    gathered through the causal 2-tap pad tables."""
    h, w = tabs.h, tabs.w
    cp = tabs.cp_base + z                              # (np, h+4, T)
    cc = torch.where((cp < 0) | (cp >= w + 4), w + 4, cp)
    i0 = torch.gather(tabs.idx[0], 2, cc)
    win = _weighted(buf[:, i0], torch.gather(tabs.wgt[0], 2, cc))
    # the second tap is only ever nonzero on the 4 vertical-pad rows
    prow = [0, 1, h + 2, h + 3]
    ccp = cc[:, prow]
    i1 = torch.gather(tabs.idx[1][:, prow], 2, ccp)
    tap1 = _weighted(buf[:, i1], torch.gather(tabs.wgt[1][:, prow], 2, ccp))
    win[:, :, prow] = win[:, :, prow] + tap1
    return win


def window_from_tables(buf: torch.Tensor, z: int, tabs: WindowTables
                       ) -> torch.Tensor:
    """The window at step z from the kernels' tables, each position
    resolved as csrc/window_common.cuh's ``window_slot`` resolves it: on an
    interior row the run inside the valid width, +0.0 outside, and the
    patch tap of the last k with tpos == t over either; on a pad row the
    two taps of pstarts + colz weighted by wz, added in the buffer dtype.
    For the tests and chip_smoke.py, which hold it to ``window_plain``."""
    B, _, CC = buf.shape
    npart, h, T = tabs.npart, tabs.h, tabs.T
    t = torch.arange(T, device=buf.device)
    win = torch.empty((B, npart, h + 4, T, CC), dtype=buf.dtype,
                      device=buf.device)
    jj = tabs.j0[z][..., None] + t                     # (np, h, T)
    run = (jj >= 0) & (jj < tabs.wl[:, None, None])
    inner = torch.where(run[..., None], buf[:, tabs.starts[z][..., None] + t],
                        0)
    v6 = _weighted(buf[:, tabs.idx6], tabs.wgt6)      # (B, np, h, 6, CC)
    for k in range(6):
        at = tabs.tpos[z][..., k, None] == t           # (np, h, T)
        inner = torch.where(at[..., None], v6[:, :, :, k, None], inner)
    win[:, :, 2:h + 2] = inner
    src = tabs.pstarts[..., None] + tabs.colz[z]       # (np, 4, 2, T)
    taps = [_weighted(buf[:, src[:, :, q]], tabs.wz[z][:, :, q])
            for q in range(2)]
    win[:, :, [0, 1, h + 2, h + 3]] = taps[0] + taps[1]
    return win


def check_buffer(buf: torch.Tensor, z: int, tabs: WindowTables,
                 kernel: str) -> None:
    """Raise unless ``buf`` is a buffer the window tables fit on its card."""
    if not buf.is_cuda:
        raise ValueError(f"{kernel} needs a CUDA tensor")
    if buf.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{kernel} takes bf16 or fp32, not {buf.dtype}")
    if (buf.dim() != 3 or buf.shape[1] != tabs.Sbuf
            or not buf.is_contiguous()):
        raise ValueError(f"buffer {tuple(buf.shape)} (contiguous="
                         f"{buf.is_contiguous()}) does not fit tables with "
                         f"Sbuf={tabs.Sbuf}")
    if not 0 <= z < tabs.starts.shape[0]:
        raise IndexError(f"step {z} outside [0, {tabs.starts.shape[0]})")
    if tabs.wl.device != buf.device:
        raise ValueError(f"tables live on {tabs.wl.device}, buffer on "
                         f"{buf.device}")
    if tabs.wz.dtype != buf.dtype:
        raise TypeError(f"tables are {tabs.wz.dtype}, buffer {buf.dtype}")


def step_table_ptrs(tabs: WindowTables, z: int) -> list[int]:
    """Device addresses of the tables a kernel reads at step z, in its
    argument order (``WindowTables.ptrs``), without making views."""
    return [p + z * step for p, step in tabs.ptrs]


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
    return _lib


def _build():
    path = build_library("window", ["window.cu"],
                         [find_nvcc()] + NVCC_FLAGS,
                         headers=("window_common.cuh",))
    lib = ctypes.CDLL(path)
    for name in ("pc_window_bf16", "pc_window_f32"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
    return lib


def window_cuda(buf: torch.Tensor, z: int, tabs: WindowTables
                ) -> torch.Tensor:
    """The same window from the CUDA kernel: one launch, nothing else on
    the device."""
    global launches
    if buf.is_cuda and buf.device.index not in (
            None, torch.cuda.current_device()):
        with torch.cuda.device(buf.device):
            return window_cuda(buf, z, tabs)
    check_buffer(buf, z, tabs, "window_cuda")
    B, Sbuf, CC = buf.shape
    out = torch.empty((B, tabs.npart, tabs.h + 4, tabs.T, CC),
                      dtype=buf.dtype, device=buf.device)
    lib = _load()
    fn = lib.pc_window_bf16 if buf.dtype == torch.bfloat16 \
        else lib.pc_window_f32
    err = fn(buf.data_ptr(), *step_table_ptrs(tabs, z), out.data_ptr(), B,
             tabs.npart, tabs.h, tabs.T, CC, Sbuf,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"window kernel launch failed: cudaError {err}")
    with _lock:
        launches += 1
    return out


def window(buf: torch.Tensor, z: int, tabs: WindowTables) -> torch.Tensor:
    """The window at step z: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor; any other device raises."""
    if buf.device.type == "cpu":
        return window_plain(buf, z, tabs)
    if buf.device.type == "cuda":
        return window_cuda(buf, z, tabs)
    raise ValueError(f"no window path for device {buf.device}")


def source_rows(z: int, tabs: WindowTables) -> int:
    """Distinct buffer rows the window at step z reads: the interior runs
    inside the valid widths, the live patch taps inside the window and the
    live pad-tap columns."""
    t = torch.arange(tabs.T, device=tabs.j0.device)
    jj = tabs.j0[z][..., None] + t                     # (np, h, T)
    run = (jj >= 0) & (jj < tabs.wl[:, None, None])
    rows = [(tabs.starts[z][..., None] + t)[run]]
    tp = tabs.tpos[z]                                  # (np, h, 6)
    rows.append(tabs.idx6[(tp >= 0) & (tp < tabs.T) & (tabs.wgt6 != 0)])
    live = tabs.wz[z] != 0                             # (np, 4, 2, T)
    prow = tabs.pstarts[..., None] + tabs.colz[z]
    rows.append(prow[live])
    return int(torch.unique(torch.cat([x.long() for x in rows])).numel())


def step_table_bytes(z: int, tabs: WindowTables) -> int:
    """Bytes of the tables one window or fused call reads at step z."""
    per_step = (tabs.starts, tabs.j0, tabs.tpos, tabs.colz, tabs.wz)
    whole = (tabs.idx6, tabs.wgt6, tabs.pstarts, tabs.wl)
    return (sum(t[z].nbytes for t in per_step)
            + sum(t.nbytes for t in whole))


def window_bytes(buf: torch.Tensor, z: int, tabs: WindowTables) -> int:
    """Bytes one window call must move at step z for this buffer: each
    distinct buffer row it reads once (runs, patch taps, pad taps), the
    step's tables once, and the output once."""
    B, _, CC = buf.shape
    es = buf.element_size()
    return (B * source_rows(z, tabs) * CC * es + step_table_bytes(z, tabs)
            + B * tabs.npart * (tabs.h + 4) * tabs.T * CC * es)
