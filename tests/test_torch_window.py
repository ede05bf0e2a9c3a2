"""The skew window: the port's plain version against the JAX package.

On the CPU the window wrapper runs the plain version (the gather through
the causal pad tables). It must equal, exactly in fp32 at every step and
for both channel widths (the hidden layers' 3*G*cpn and the input plane's
G), the JAX package's gather window (``_window``) on any buffer and its
Pallas kernel (``_window_pallas``, interpret mode) on a buffer that is
zero outside the valid cells, as the codec's buffers are. The plain
version built from the CUDA kernel's own tables (``window_from_tables``)
must equal it bit for bit. The CUDA kernel itself runs only on a card:
tests/test_torch_gpu.py holds it against the plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pseudocylindrical_convolution_tpu.codec.wavefront_scan import (
    ScanWavefrontCodec as JaxScan)

from pseudocylindrical_convolution_torch.codec import window_kernel as wk
from pseudocylindrical_convolution_torch.codec.wavefront import (
    wavefront_schedule)
from pseudocylindrical_convolution_torch.codec.wavefront_scan import (
    ScanWavefrontCodec)
from pseudocylindrical_convolution_torch.geometry import Geometry

from torch_parity import CFG, JCFG

H, W, B = 2, 16, 2


@pytest.fixture(scope="module")
def codecs():
    jg = JaxScan(JCFG, JCFG.geometry(), H, W, batch=B, lanes=4,
                 dtype=jnp.float32, window_mode="gather")
    jp = JaxScan(JCFG, JCFG.geometry(), H, W, batch=B, lanes=4,
                 dtype=jnp.float32, window_mode="pallas")
    tc = ScanWavefrontCodec(CFG, CFG.geometry(), H, W, batch=B, lanes=4,
                            dtype=torch.float32, device="cpu")
    return jg, jp, tc


def _valid_only(x, geom):
    """Zero the columns past each band's valid width (flat (B, S, CC))."""
    x = x.reshape(B, geom.npart, H, W, -1).copy()
    for b, wl in enumerate(geom.hindex(H * geom.npart, W)):
        x[:, b, :, int(wl):] = 0
    return x.reshape(B, geom.npart * H * W, -1)


@pytest.mark.parametrize("CC", [3 * CFG.ngroup * 3, CFG.ngroup])
def test_plain_window_matches_jax(codecs, CC):
    jg, jp, tc = codecs
    tabs = tc.tabs
    M1, S = tabs.row_off, jg.S
    rng = np.random.default_rng(CC)
    x = rng.standard_normal((B, S, CC)).astype(np.float32)
    # port buffer: random margins and trash row, which nothing may read
    pbuf = rng.standard_normal((B, tabs.Sbuf, CC)).astype(np.float32)
    pbuf[:, M1:M1 + S] = x
    xv = _valid_only(x, CFG.geometry())
    jbuf = np.zeros((B, jp.Sbuf, CC), np.float32)
    jbuf[:, jp._row_off:jp._row_off + S] = xv
    pbuf_v = pbuf.copy()
    pbuf_v[:, M1:M1 + S] = xv
    bad_g = bad_p = 0
    for z in range(tc.nsteps):
        got = wk.window(torch.as_tensor(pbuf), z, tabs).numpy()
        bad_g += int((got != np.asarray(
            jg._window(jnp.asarray(x), jnp.int32(z)))).sum())
        got_v = wk.window(torch.as_tensor(pbuf_v), z, tabs).numpy()
        bad_p += int((got_v != np.asarray(
            jp._window_pallas(jnp.asarray(jbuf), jnp.int32(z)))).sum())
    assert (bad_g, bad_p) == (0, 0)


def test_wrapper_takes_plain_version_on_cpu_only(codecs):
    _, _, tc = codecs
    buf = torch.randn(B, tc.Sbuf, CFG.ngroup)
    before = wk.launches
    np.testing.assert_array_equal(wk.window(buf, 3, tc.tabs).numpy(),
                                  wk.window_plain(buf, 3, tc.tabs).numpy())
    assert wk.launches == before
    with pytest.raises(ValueError):
        wk.window_cuda(buf, 3, tc.tabs)
    with pytest.raises(ValueError):
        wk.window(buf.to("meta"), 3, tc.tabs)


def _plain_rows(z, tabs):
    """Distinct buffer rows window_plain reads with a nonzero weight."""
    cp = tabs.cp_base + z
    cc = torch.where((cp < 0) | (cp >= tabs.w + 4), tabs.w + 4, cp)
    rows = [torch.gather(tabs.idx[q], 2, cc)[
        torch.gather(tabs.wgt[q], 2, cc) != 0] for q in range(2)]
    return int(torch.unique(torch.cat(rows)).numel())


def test_window_bytes_counts_rows_and_output(codecs):
    """The bound's bytes: each buffer row the kernel reads (the runs, the
    patch taps it now reads itself, the pad taps) once -- the rows the
    plain gather reads with a nonzero weight -- the step's tables and the
    output."""
    _, _, tc = codecs
    tabs = tc.tabs
    for z in range(tc.nsteps):
        assert wk.source_rows(z, tabs) == _plain_rows(z, tabs), z
    z = tc.nsteps // 2
    buf = torch.zeros(1, tc.Sbuf, 18)
    out_bytes = tc.npart * (H + 4) * tabs.T * 18 * 4
    n = wk.window_bytes(buf, z, tabs)
    assert n == (_plain_rows(z, tabs) * 18 * 4 + wk.step_table_bytes(z, tabs)
                 + out_bytes)
    assert out_bytes < n < 3 * out_bytes


BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _tables(npart, h, w, G, dtype):
    geom = Geometry(npart=npart)
    _, _, nsteps = wavefront_schedule(geom, h, w, G)
    return wk.build_window_tables(geom, h, w, G, nsteps, dtype, "cpu"), nsteps


def _mismatches(buf, steps, tabs):
    """Elements where window_from_tables and window_plain differ in bits,
    over the given steps."""
    bits = BITS[buf.dtype]
    return sum(int((wk.window_from_tables(buf, z, tabs).view(bits)
                    != wk.window_plain(buf, z, tabs).view(bits)).sum())
               for z in steps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_window_from_tables_matches_plain(dtype):
    """The kernel's tables give window_plain's bits at every step of the
    tiny configuration, for both widths, on random buffers of B=2 images
    (margins and trash row included)."""
    tabs, nsteps = _tables(CFG.npart, H, W, CFG.ngroup, dtype)
    rng = np.random.default_rng(3)
    for CC in (3 * CFG.ngroup * 3, CFG.ngroup):
        buf = torch.as_tensor(rng.standard_normal(
            (B, tabs.Sbuf, CC)).astype(np.float32)).to(dtype)
        assert _mismatches(buf, range(nsteps), tabs) == 0, CC


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_window_from_tables_keeps_negative_zero_patches(dtype):
    """With -0.0 at every patch source row, a patch element is its one tap
    as it is (-0.0 times a positive weight stays -0.0), as in window_plain;
    a second +0.0 tap added to it would make it +0.0."""
    tabs, nsteps = _tables(CFG.npart, H, W, CFG.ngroup, dtype)
    rng = np.random.default_rng(4)
    CC = 3 * CFG.ngroup * 3
    buf = torch.as_tensor(rng.standard_normal(
        (B, tabs.Sbuf, CC)).astype(np.float32)).to(dtype)
    buf[:, tabs.idx6[tabs.wgt6 != 0].long()] = -0.0
    bits = BITS[dtype]
    negzero = 0
    for z in range(nsteps):
        want = wk.window_plain(buf, z, tabs)[:, :, 2:H + 2]
        tp = tabs.tpos[z]
        live = (tp >= 0) & (tp < tabs.T) & (tabs.wgt6 > 0)
        for b, r, k in live.nonzero().tolist():
            cell = want[:, b, r, tp[b, r, k]]
            negzero += int((cell.view(bits) == torch.tensor(
                -0.0, dtype=dtype).view(bits)).sum())
    assert negzero > 0
    assert _mismatches(buf, range(nsteps), tabs) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_window_from_tables_flagship_geometry(dtype):
    """The flagship geometry (npart=16, h=4, w=128, G=48: 238 steps), tables
    only, at the input plane's width CC=48: window_plain's bits on 12
    steps spread over the 238."""
    tabs, nsteps = _tables(16, 4, 128, 48, dtype)
    assert nsteps == 238
    rng = np.random.default_rng(5)
    buf = torch.as_tensor(rng.standard_normal(
        (1, tabs.Sbuf, 48)).astype(np.float32)).to(dtype)
    steps = np.linspace(0, nsteps - 1, 12).round().astype(int).tolist()
    assert _mismatches(buf, steps, tabs) == 0
