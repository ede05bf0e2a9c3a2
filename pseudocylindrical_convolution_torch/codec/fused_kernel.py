"""The scan codec's fused layer-step: CUDA kernel (csrc/fused.cu), plain
version.

In the fused profile (``ScanWavefrontCodec(window_mode="fused")``) one
layer-step is one kernel: it assembles the skew window of the layer buffer
on chip and contracts it with the layer's sheared 9x5 kernel, so neither
the window nor the conv's taps reach device memory. This module holds

  * ``fused_plain``: ``window_plain`` followed by the kernel's contraction
    written as 45 fp32 tap products accumulated in tap order (the
    decomposition of the JAX package's ``codec/pallas_fused.py``) -- the
    CPU path and the kernel's reference;
  * ``fused_cuda``: the same cells from the CUDA kernel that replaces the
    JAX package's Pallas kernel ``codec/pallas_fused.py::_fused_kernel``;
  * ``fused``: the wrapper the codec calls. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.

Both take the window tables of ``codec/window_kernel.py`` and a fused
kernel K (3*G, 45*CI, n) in the buffer dtype, rows (dt, di, ci), batch
(subnet s, group g): output group g reads window slices [G-1-g, G+8-g),
and subnet s reads channels [s*CI, (s+1)*CI) of a hidden layer's buffer
(CC = 3*CI) or all G channels of the input plane (CC = CI). Both return
fp32 cells (B, npart, h, 3*G*n), channels (subnet, group, n), before bias
and PReLU.

The window elements are the same bits in both (the kernel builds them with
the window kernel's device code), and every product is exact in fp32 for
bf16 operands; only the order of the fp32 sums differs. So the kernel is
held to its plain version within ``TOL`` times the sum of the absolute
products of each cell (``fused_tolerance``), the form of the standard
bound on a reordered fp32 sum. Bit-exactness of a fused stream rests on
the kernel alone: its sum order is fixed by the shapes, so an encode and a
decode on the card agree.

``fused_ordered`` takes the kernel's own sum order instead, for bf16
operands, and is held to the kernel bit for bit: each cell's 45*CI terms
are split over ``THREADS`` threads (thread t sums terms t, t+256, ... in
order from +0), then a butterfly over each warp's 32 lanes, then the
warps' sums in warp order. Only the tests and chip_smoke.py call it; the
codec never does.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from pseudocylindrical_convolution_torch.codec.window_kernel import (
    NVCC_FLAGS, WindowTables, check_buffer, source_rows, step_table_bytes,
    step_table_ptrs, window_plain)
from pseudocylindrical_convolution_torch.utils.build import (
    build_library, find_nvcc)

# |kernel - plain| <= TOL * sum |products| per cell. A reordered sum of
# 45*CI fp32 terms stays within about sqrt(45*CI) * 2^-24 of that scale in
# practice (5e-6 at CI=144); one term lost or doubled moves a cell by about
# 1/(45*CI) of it (1.5e-4 at CI=144, 5e-4 at CI=48), far outside.
TOL = 1e-5
MAX_H = 8           # the kernel's register tile: rows per band
MAX_N = 4           # ... and output channels per (subnet, group)
THREADS = 256       # the kernel's block: the strided shares of each cell
WARP = 32

# Launches of the CUDA kernel (one per ``fused`` call on a CUDA tensor).
launches = 0
_lib = None
# replicas of the scan codec launch from several host threads
_lock = threading.Lock()


def contract(win: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 cells (B, npart, h, 3*G*n) of a window (B, npart, h+4, T, CC)
    and a fused kernel K (3*G, 45*CI, n): the (h, CI) x (CI, n) products of
    every tap (dt, di) and (subnet, group), then their sum over the taps,
    added in tap order into an fp32 accumulator."""
    B, npart, hp4, T, CC = win.shape
    h, G = hp4 - 4, T - 8
    CI, n = k.shape[1] // 45, k.shape[2]
    x = win.float()
    x = (x.reshape(B, npart, hp4, T, 3, CI) if CC == 3 * CI
         else x[..., None, :].expand(B, npart, hp4, T, 3, CI)).contiguous()
    s = x.stride()
    # taps[dt, di, b, p, r, t', s, c] = window[b, p, r+di, dt+t', s, c];
    # group g reads window slice G-1-g+dt, so t' = G-1-g: flip t'
    taps = x.as_strided((9, 5, B, npart, h, G, 3, CI),
                        (s[3], s[2], s[0], s[1], s[2], s[3], s[4], s[5]))
    prods = torch.einsum("tubprgsc,sgtucn->tubprsgn", taps.flip(5),
                         k.float().reshape(3, G, 9, 5, CI, n))
    acc = torch.zeros(prods.shape[2:], dtype=torch.float32,
                      device=win.device)
    for tap in prods.reshape((45,) + prods.shape[2:]):
        acc = acc + tap
    return acc.reshape(B, npart, h, 3 * G * n)


def fused_plain(buf: torch.Tensor, z: int, tabs: WindowTables,
                k: torch.Tensor) -> torch.Tensor:
    """Cells of the layer-step at step z: the plain window, contracted."""
    return contract(window_plain(buf, z, tabs), k)


def ordered_sum(terms: torch.Tensor) -> torch.Tensor:
    """fp32 sums over the last axis in the kernel's order: thread t of
    ``THREADS`` adds terms t, t+THREADS, ... in order into +0 (the terms
    padded with +0 to whole trips), a butterfly over each warp's lanes
    (lane i adds lane i+o, o = 16 ... 1), then the warps' sums in warp
    order into +0."""
    nq = terms.shape[-1]
    trips = -(-nq // THREADS)
    x = torch.nn.functional.pad(terms.float(), (0, trips * THREADS - nq))
    x = x.reshape(terms.shape[:-1] + (trips, THREADS))
    acc = torch.zeros(x.shape[:-2] + (THREADS,), dtype=torch.float32,
                      device=terms.device)
    for i in range(trips):
        acc = acc + x[..., i, :]
    acc = acc.reshape(acc.shape[:-1] + (THREADS // WARP, WARP))
    o = WARP // 2
    while o:
        acc = acc[..., :o] + acc[..., o:2 * o]
        o //= 2
    out = torch.zeros(acc.shape[:-2], dtype=torch.float32,
                      device=terms.device)
    for w in range(THREADS // WARP):
        out = out + acc[..., w, 0]
    return out


def contract_ordered(win: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``contract`` with the kernel's sum order (``ordered_sum``) over each
    cell's 45*CI products, taken 4 bands at a time to bound the memory of
    the products (0.7 GB for all 16 at the flagship). bf16 operands only:
    their products are exact in fp32, as in the kernel's fmaf; an fp32
    product would round here and not there."""
    if win.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        raise TypeError(f"the kernel's order is emulated for bf16 operands "
                        f"only, not {win.dtype} x {k.dtype}: fmaf does not "
                        f"round an fp32 product, a torch multiply does")
    B, npart, hp4, T, CC = win.shape
    h, G = hp4 - 4, T - 8
    CI, n = k.shape[1] // 45, k.shape[2]
    # K as (s, g, j, dt, di, ci): each cell's terms in K's row order
    kq = k.float().reshape(3, G, 9, 5, CI, n).permute(0, 1, 5, 2, 3, 4)
    out = []
    for p0 in range(0, npart, 4):
        x = win[:, p0:p0 + 4].float()
        nb = x.shape[1]
        x = (x.reshape(B, nb, hp4, T, 3, CI) if CC == 3 * CI
             else x[..., None, :].expand(B, nb, hp4, T, 3, CI)).contiguous()
        s = x.stride()
        # taps[b, p, r, s, t', dt, di, c] = window[b, p, r+di, dt+t', s, c]
        taps = x.as_strided((B, nb, h, 3, G, 9, 5, CI),
                            (s[0], s[1], s[2], s[4], s[3], s[3], s[2], s[5]))
        prods = taps.flip(4)[:, :, :, :, :, None] * kq
        out.append(ordered_sum(prods.reshape(B, nb, h, 3 * G * n, 45 * CI)))
    return torch.cat(out, 1)


def fused_ordered(buf: torch.Tensor, z: int, tabs: WindowTables,
                  k: torch.Tensor) -> torch.Tensor:
    """The kernel's cells, bit for bit, for bf16 buffers: the plain window,
    contracted in the kernel's sum order."""
    return contract_ordered(window_plain(buf, z, tabs), k)


def fused_tolerance(buf: torch.Tensor, z: int, tabs: WindowTables,
                    k: torch.Tensor) -> torch.Tensor:
    """Per cell, how far the kernel may be from ``fused_plain``: ``TOL``
    times the sum of the cell's absolute products."""
    return TOL * contract(window_plain(buf, z, tabs).abs(), k.abs())


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
    return _lib


def _build():
    path = build_library("fused", ["fused.cu"],
                         [find_nvcc()] + NVCC_FLAGS,
                         headers=("window_common.cuh",))
    lib = ctypes.CDLL(path)
    for name in ("pc_fused_bf16", "pc_fused_f32"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
    lib.pc_fused_info.restype = ctypes.c_int
    lib.pc_fused_info.argtypes = [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int)]
    return lib


INFO_KEYS = ("NB", "groups_per_block", "smem_bytes", "registers",
             "spill_bytes", "blocks")


def kernel_info(dtype: torch.dtype, tabs: WindowTables, CC: int, CI: int,
                n: int) -> dict:
    """What a launch of the CUDA kernel runs at this shape (B=1, 16-byte
    aligned operands): its bands per block NB, output groups per block,
    dynamic shared memory per block, registers and spill bytes per thread,
    and blocks. Needs the card."""
    info = (ctypes.c_int * len(INFO_KEYS))()
    err = _load().pc_fused_info(int(dtype == torch.bfloat16), tabs.npart,
                                tabs.h, tabs.T, CC, CI, n, info)
    if err != 0:
        raise RuntimeError(f"pc_fused_info failed: cudaError {err}")
    return dict(zip(INFO_KEYS, info))


def _check_kernel(buf: torch.Tensor, tabs: WindowTables,
                  k: torch.Tensor) -> tuple[int, int]:
    """Raise unless K fits the buffer and the kernel; returns (CI, n)."""
    CC, G = buf.shape[2], tabs.G
    if k.device != buf.device or k.dtype != buf.dtype:
        raise TypeError(f"K is {k.dtype} on {k.device}, the buffer "
                        f"{buf.dtype} on {buf.device}")
    if (k.dim() != 3 or k.shape[0] != 3 * G or k.shape[1] % 45
            or not k.is_contiguous()):
        raise ValueError(f"K {tuple(k.shape)} (contiguous="
                         f"{k.is_contiguous()}) is not a contiguous "
                         f"(3*G={3 * G}, 45*CI, n) kernel")
    CI, n = k.shape[1] // 45, k.shape[2]
    if CC not in (CI, 3 * CI):
        raise ValueError(f"buffer width {CC} is neither CI={CI} nor 3*CI")
    if tabs.h > MAX_H or not 1 <= n <= MAX_N:
        raise ValueError(f"the fused kernel takes h <= {MAX_H} and "
                         f"1 <= n <= {MAX_N}, not h={tabs.h}, n={n}")
    return CI, n


def fused_cuda(buf: torch.Tensor, z: int, tabs: WindowTables,
               k: torch.Tensor) -> torch.Tensor:
    """The same cells from the CUDA kernel: one launch, nothing else on
    the device."""
    global launches
    if buf.is_cuda and buf.device.index not in (
            None, torch.cuda.current_device()):
        with torch.cuda.device(buf.device):
            return fused_cuda(buf, z, tabs, k)
    check_buffer(buf, z, tabs, "fused_cuda")
    CI, n = _check_kernel(buf, tabs, k)
    B, Sbuf, CC = buf.shape
    h, npart, T, G = tabs.h, tabs.npart, tabs.T, tabs.G
    out = torch.empty((B, npart, h, 3 * G * n), dtype=torch.float32,
                      device=buf.device)
    lib = _load()
    fn = lib.pc_fused_bf16 if buf.dtype == torch.bfloat16 \
        else lib.pc_fused_f32
    err = fn(buf.data_ptr(), *step_table_ptrs(tabs, z), k.data_ptr(),
             out.data_ptr(), B, npart, h, T, CC, CI, n, Sbuf,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused kernel launch failed: cudaError {err}")
    with _lock:
        launches += 1
    return out


def fused(buf: torch.Tensor, z: int, tabs: WindowTables,
          k: torch.Tensor) -> torch.Tensor:
    """The layer-step's cells at step z: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor; any other device raises."""
    if buf.device.type == "cpu":
        return fused_plain(buf, z, tabs, k)
    if buf.device.type == "cuda":
        return fused_cuda(buf, z, tabs, k)
    raise ValueError(f"no fused path for device {buf.device}")


def fused_bytes(buf: torch.Tensor, z: int, tabs: WindowTables,
                k: torch.Tensor) -> int:
    """Bytes one fused call must move at step z: each distinct buffer row
    it reads once, the step's tables and K once, and the fp32 cells
    once."""
    B, _, CC = buf.shape
    cells = B * tabs.npart * tabs.h * 3 * tabs.G * k.shape[2]
    return (B * source_rows(z, tabs) * CC * buf.element_size()
            + step_table_bytes(z, tabs) + k.numel() * k.element_size()
            + cells * 4)


def fused_flops(buf: torch.Tensor, tabs: WindowTables,
                k: torch.Tensor) -> int:
    """Operations of one fused call: a multiply and an add for each of the
    45*CI terms of every cell."""
    cells = buf.shape[0] * tabs.npart * tabs.h * 3 * tabs.G * k.shape[2]
    return 2 * cells * k.shape[1]
