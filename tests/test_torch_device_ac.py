"""The PyTorch port's on-device arithmetic decoder against the C++ coder.

The port's lane encoder (its own build of csrc/coder.cpp) and its int64
decoder (codec/device_ac.py) must implement the identical Nayuki-32 state
machine: every decoded symbol must equal the encoded one, and the port's
single-stream coder must write the bytes the lane encoder writes, from
packed ranges and from whole CDF rows alike.
"""

import numpy as np
import torch

from pseudocylindrical_convolution_torch.codec import device_ac
from pseudocylindrical_convolution_torch.codec.coder_bridge import (
    Coder, encode_lanes)

TOTAL = 65536


def _random_tables(n, rng, skew_every=0):
    """(n, 9) strictly increasing CDF rows, [0]=0, [8]=TOTAL; every
    skew_every-th row puts almost all mass on symbol 7 (long renorms)."""
    t = np.zeros((n, 9), np.int64)
    for i in range(n):
        if skew_every and i % skew_every == 0:
            t[i, 1:8] = np.arange(1, 8)
        else:
            t[i, 1:8] = np.sort(rng.choice(np.arange(1, TOTAL), 7,
                                           replace=False))
    t[:, 8] = TOTAL
    return t


def _pack(tables, syms):
    rows = np.arange(len(syms))
    return (tables[rows, syms] | ((tables[rows, syms + 1] - 1) << 16)
            ).astype(np.uint32)


def test_single_stream_matches_lane_encoder():
    rng = np.random.default_rng(0)
    n = 400
    tables = _random_tables(n, rng)
    syms = rng.integers(0, 8, n)
    packed = _pack(tables, syms)
    c = Coder()
    c.start_encoder()
    c.encode_packed(packed, TOTAL)
    one = c.end_encoder_buf()
    payload, lane_nbytes = encode_lanes(packed, np.array([0, n]))
    assert payload == one and int(lane_nbytes[0]) == len(one)
    # the same symbols from whole CDF rows (the incremental encoder's call)
    e = Coder()
    e.start_encoder()
    e.encodes(tables, 8, syms, n)
    assert e.end_encoder_buf() == one
    d = Coder()
    d.start_decoder_buf(one)
    np.testing.assert_array_equal(d.decodes(tables, 8, n), syms)


def _decode_lanes(payload, lane_nbytes, tables, n, L):
    words, word_off = [], []
    pos = 0
    for nb in lane_nbytes:
        nb = int(nb)
        wb = np.zeros(((nb + 3) // 4) * 4, np.uint8)
        wb[:nb] = np.frombuffer(payload, np.uint8, count=nb, offset=pos)
        pos += nb
        w32 = wb.reshape(-1, 4).astype(np.int64)
        word_off.append(len(words))
        words.extend(((w32[:, 0] << 24) | (w32[:, 1] << 16)
                      | (w32[:, 2] << 8) | w32[:, 3]).tolist())
    words_t = torch.tensor(words + [0], dtype=torch.int64)
    st = device_ac.init_state(words_t, torch.tensor(word_off),
                              torch.tensor(np.asarray(lane_nbytes,
                                                      np.int64) * 8))
    out = np.zeros(n, np.int64)
    for r in range(0, n, L):
        m = min(L, n - r)
        cdf = np.repeat(tables[:1], L, axis=0)
        cdf[:m] = tables[r:r + m]
        st, s = device_ac.decode_symbols(st, words_t, torch.tensor(cdf),
                                         torch.arange(L) < m)
        out[r:r + m] = s[:m].numpy()
        assert (s[m:] == 0).all()
    return out


def test_device_decode_matches_cpp_lanes():
    rng = np.random.default_rng(1)
    for L, n, skew in ((8, 1200, 0), (5, 3001, 3), (64, 640, 2)):
        tables = _random_tables(n, rng, skew)
        syms = rng.integers(0, 8, n)
        if skew:
            syms[::skew] = 7
        lane = np.arange(n) % L
        perm = np.argsort(lane, kind="stable")
        offs = np.concatenate([[0], np.cumsum(np.bincount(lane,
                                                          minlength=L))])
        payload, lane_nbytes = encode_lanes(_pack(tables, syms)[perm], offs)
        got = _decode_lanes(payload, lane_nbytes, tables, n, L)
        assert int((got != syms).sum()) == 0, (L, n, skew)


def test_clz_and_shift16_edges():
    x = torch.tensor([0, 1, 2, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
    np.testing.assert_array_equal(device_ac._clz32(x).numpy(),
                                  [32, 31, 30, 30, 1, 0, 0])
    # c = total with range = 2**32 wraps to 0 (used only as low + r - 1)
    full = torch.tensor(0xFFFFFFFF)
    assert int(device_ac._shift16(torch.tensor(65536), full >> 16,
                                  full & 0xFFFF)) == 0
    c = torch.arange(0, 65537, 4097)
    rm1 = torch.tensor(0x12345678)
    want = (c * (int(rm1) + 1)) // 65536
    np.testing.assert_array_equal(
        device_ac._shift16(c, rm1 >> 16, rm1 & 0xFFFF).numpy(),
        want.numpy() & 0xFFFFFFFF)
