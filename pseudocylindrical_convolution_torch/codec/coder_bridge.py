"""ctypes bridge to the native arithmetic coder (csrc/coder.cpp).

The port's own copy of the coder source, built with g++ into the port's
hash-keyed build directory (utils/build.py) at first use. API mirrors the
JAX package's ``codec/coder_bridge.py`` (itself after the reference's
``coder.coder`` object, coder/python.cpp:63-73).
"""

from __future__ import annotations

import ctypes

import numpy as np

from pseudocylindrical_convolution_torch.utils.build import build_library

_lib = None
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def load_library():
    """Build (if needed) and load the coder library."""
    global _lib
    if _lib is not None:
        return _lib
    path = build_library("pcoder", ["coder.cpp"],
                         ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"])
    lib = ctypes.CDLL(path)
    lib.pcoder_create.restype = ctypes.c_void_p
    lib.pcoder_create.argtypes = [ctypes.c_char_p]
    lib.pcoder_destroy.argtypes = [ctypes.c_void_p]
    lib.pcoder_start_encoder.argtypes = [ctypes.c_void_p]
    lib.pcoder_encode_packed.argtypes = [ctypes.c_void_p, _u32p, ctypes.c_int,
                                         ctypes.c_int32]
    lib.pcoder_end_encoder_buf.restype = ctypes.c_long
    lib.pcoder_end_encoder_buf.argtypes = [ctypes.c_void_p, _u8p,
                                           ctypes.c_long]
    lib.pcoder_start_decoder_buf.argtypes = [ctypes.c_void_p, _u8p,
                                             ctypes.c_long]
    lib.pcoder_decodes.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int,
                                   ctypes.c_int, _i32p]
    lib.pcoder_encodes.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int,
                                   _i32p, ctypes.c_int]
    lib.pcoder_encode_lanes.restype = ctypes.c_long
    lib.pcoder_encode_lanes.argtypes = [_u32p, _i64p, ctypes.c_int,
                                        ctypes.c_int32, _u8p, ctypes.c_long,
                                        _i32p]
    _lib = lib
    return lib


def encode_lanes(packed: np.ndarray, lane_offsets: np.ndarray,
                 total: int = 65536):
    """Encode L independent arithmetic-coder lanes in one native call.

    packed: lane-concatenated (low | (high-1) << 16) uint32 words;
    lane_offsets: (L+1,) int64 prefix offsets into packed.
    Returns (payload bytes with lane blocks back to back, lane_nbytes (L,)).
    """
    lib = load_library()
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    offs = np.ascontiguousarray(lane_offsets, dtype=np.int64)
    nlanes = offs.shape[0] - 1
    lane_nbytes = np.zeros(nlanes, np.int32)
    cap = int(packed.shape[0]) * 4 + 16 * nlanes + 64
    while True:
        out = np.zeros(cap, np.uint8)
        n = int(lib.pcoder_encode_lanes(
            packed.ctypes.data_as(_u32p), offs.ctypes.data_as(_i64p),
            nlanes, total, out.ctypes.data_as(_u8p), cap,
            lane_nbytes.ctypes.data_as(_i32p)))
        if n >= 0:
            return out[:n].tobytes(), lane_nbytes
        cap = -n


class Coder:
    """One in-memory arithmetic coding session (single stream)."""

    def __init__(self):
        self._lib = load_library()
        self._h = self._lib.pcoder_create(b"")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pcoder_destroy(self._h)
            self._h = None

    def start_encoder(self):
        self._lib.pcoder_start_encoder(self._h)

    def encodes(self, tables: np.ndarray, ncode: int, symbols: np.ndarray,
                n: int):
        """tables: (n, ncode+1) int32 CDF rows; symbols: (n,) in
        [0, ncode)."""
        if n:
            tables = np.ascontiguousarray(tables, dtype=np.int32)
            symbols = np.ascontiguousarray(symbols, dtype=np.int32)
            assert tables.shape[0] >= n and tables.shape[1] == ncode + 1
            assert symbols.shape[0] >= n
            self._lib.pcoder_encodes(self._h, tables.ctypes.data_as(_i32p),
                                     ncode, symbols.ctypes.data_as(_i32p), n)

    def encode_packed(self, packed: np.ndarray, total: int = 65536):
        """packed: (n,) uint32, v = low | ((high-1) << 16); fixed total."""
        packed = np.ascontiguousarray(packed, dtype=np.uint32)
        if packed.shape[0]:
            self._lib.pcoder_encode_packed(
                self._h, packed.ctypes.data_as(_u32p), packed.shape[0], total)

    def end_encoder_buf(self) -> bytes:
        """Flush and return the payload bytes."""
        cap = 1 << 16
        while True:
            out = np.zeros(cap, np.uint8)
            n = int(self._lib.pcoder_end_encoder_buf(
                self._h, out.ctypes.data_as(_u8p), cap))
            if n >= 0:
                return out[:n].tobytes()
            cap = -n

    def start_decoder_buf(self, data: bytes):
        self._buf = np.frombuffer(data, np.uint8).copy()
        self._lib.pcoder_start_decoder_buf(
            self._h, self._buf.ctypes.data_as(_u8p), len(data))

    def decodes(self, tables: np.ndarray, ncode: int, n: int) -> np.ndarray:
        """tables: (n, ncode+1) int32 CDF rows -> (n,) int32 symbols."""
        out = np.zeros((n,), np.int32)
        if n:
            tables = np.ascontiguousarray(tables, dtype=np.int32)
            assert tables.shape[0] >= n and tables.shape[1] == ncode + 1
            self._lib.pcoder_decodes(self._h, tables.ctypes.data_as(_i32p),
                                     ncode, n, out.ctypes.data_as(_i32p))
        return out
