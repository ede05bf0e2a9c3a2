"""Self-describing bitstream container (the JAX package's layout).

Layout (big-endian), as ``pseudocylindrical_convolution_tpu/codec/
container.py`` writes it:
  magic  4s   b"PC60"
  ver    u8   1
  mode   u8   0 = dense, 1 = scan, 2 = incremental
  npart  u8
  flags  u8   bit 0 FLAG_BF16 (bf16 activation buffers); bits 1-3 are JAX
              window modes (burst, slab, hoist); bits 4-7 conv_chunks - 1
  vdim   u16  valid_dim
  h, w   u16  latent plane dims
  lanes  u16  scan mode only (0 for dense and incremental)
  batch  u8   scan executable batch (0 for dense and incremental)
  flags2 u8   bits 0-3 are JAX window modes (mm pads, Pallas window,
              fused step, fused unrolled), which this port never sets;
              bit 4 (FLAG2_TORCH) marks a stream written by this port;
              bit 5 (FLAG2_TORCH_FUSED) marks the port's fused profile
              (one CUDA kernel per layer-step, codec/fused_kernel.py).
  [lanes * u32 lane_nbytes]   scan mode only
  payload bytes

Bit-exactness is per executable, so a stream decodes only on the program
that wrote it. FLAG2_TORCH makes each package refuse the other's streams:
the port's reader rejects a stream without it, and the JAX package's
profile check sees a flags2 it does not produce. FLAG2_TORCH_FUSED is the
port's own bit, not the JAX fused-step bit: the two fused kernels sum in
other orders, so neither program can decode the other's fused streams,
and the JAX bits stay refused by name.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"PC60"
VERSION = 1
MODE_DENSE = 0
MODE_SCAN = 1
MODE_INCR = 2
MODE_NAMES = {MODE_DENSE: "dense", MODE_SCAN: "scan",
              MODE_INCR: "incremental"}
FLAG_BF16 = 1
FLAG_BURST = 2
FLAG_SLAB = 4
FLAG_HOIST = 8
CHUNKS_SHIFT = 4        # bits 4-7 hold conv_chunks - 1
FLAG2_MMPAD = 1
FLAG2_PALLASWIN = 2
FLAG2_FUSEDSTEP = 4
FLAG2_FUSEDUNROLL = 8
FLAG2_TORCH = 16
FLAG2_TORCH_FUSED = 32
_JAX_ONLY = (("flags", FLAG_BURST, "burst window"),
             ("flags", FLAG_SLAB, "slab window"),
             ("flags", FLAG_HOIST, "hoisted window"),
             ("flags2", FLAG2_MMPAD, "mm pad rows"),
             ("flags2", FLAG2_PALLASWIN, "Pallas window"),
             ("flags2", FLAG2_FUSEDSTEP, "fused window+conv step"),
             ("flags2", FLAG2_FUSEDUNROLL, "fused unrolled step"))
_FMT = ">4sBBBBHHHHBB"
_HLEN = struct.calcsize(_FMT)


def write_stream(fname: str, mode: int, npart: int, valid_dim: int, h: int,
                 w: int, payload: bytes, lanes: int = 0, batch: int = 0,
                 lane_nbytes=None, flags: int = 0, flags2: int = 0) -> int:
    """Write header + payload; returns total file size in bytes. The
    port's FLAG2_TORCH bit is always set."""
    hdr = struct.pack(_FMT, MAGIC, VERSION, mode, npart, flags, valid_dim,
                      h, w, lanes, batch, flags2 | FLAG2_TORCH)
    body = b""
    if mode == MODE_SCAN:
        assert lanes and lane_nbytes is not None and len(lane_nbytes) == lanes
        body = np.asarray(lane_nbytes, ">u4").tobytes()
    with open(fname, "wb") as f:
        f.write(hdr)
        f.write(body)
        f.write(payload)
    return _HLEN + len(body) + len(payload)


def read_stream(fname: str) -> dict:
    """Parse a stream written by this port; raise on anything else."""
    with open(fname, "rb") as f:
        data = f.read()
    if len(data) < _HLEN or data[:4] != MAGIC:
        raise ValueError(f"{fname}: not a PC60 bitstream (bad magic)")
    (magic, ver, mode, npart, flags, vdim, h, w, lanes, batch,
     flags2) = struct.unpack(_FMT, data[:_HLEN])
    if ver != VERSION:
        raise ValueError(f"{fname}: unsupported container version {ver}")
    if not flags2 & FLAG2_TORCH:
        raise ValueError(
            f"{fname}: stream was written by the JAX package (no "
            f"FLAG2_TORCH bit); streams decode only on the program that "
            f"wrote them")
    for field, bit, name in _JAX_ONLY:
        if (flags if field == "flags" else flags2) & bit:
            raise ValueError(f"{fname}: stream uses the JAX-only {name} "
                             f"profile, which this port does not have")
    off = _HLEN
    lane_nbytes = None
    if mode == MODE_SCAN:
        lane_nbytes = np.frombuffer(data, ">u4", count=lanes, offset=off)
        lane_nbytes = lane_nbytes.astype(np.int64)
        off += 4 * lanes
    return {"mode": mode, "npart": npart, "valid_dim": vdim, "h": h, "w": w,
            "lanes": lanes, "batch": batch, "lane_nbytes": lane_nbytes,
            "flags": flags, "flags2": flags2, "payload": data[off:]}


def check_stream(hdr: dict, fname: str, mode: int, npart: int,
                 valid_dim: int, h: int, w: int):
    """Raise if a parsed header does not match the decoding configuration."""
    want = {"mode": mode, "npart": npart, "valid_dim": valid_dim, "h": h,
            "w": w}
    got = {k: hdr[k] for k in want}
    if got != want:
        raise ValueError(
            f"{fname}: stream/config mismatch: stream has {got}, decoder "
            f"expects {want}")
    if mode != MODE_SCAN and (hdr["flags"], hdr["flags2"]) != (0,
                                                               FLAG2_TORCH):
        raise ValueError(
            f"{fname}: stream profile flags {(hdr['flags'], hdr['flags2'])} "
            f"do not belong to the port's {MODE_NAMES[mode]} mode")
