"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card (marker ``gpu``) and skip on a machine
without one. They import no JAX, so they also run where JAX is not
installed; there, skip the JAX-importing conftest:

  python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from pseudocylindrical_convolution_torch.codec import fused_kernel as fk
from pseudocylindrical_convolution_torch.codec import window_kernel as wk
from pseudocylindrical_convolution_torch.codec.wavefront import (
    wavefront_schedule)
from pseudocylindrical_convolution_torch.codec.wavefront_scan import (
    ScanWavefrontCodec)
from pseudocylindrical_convolution_torch.geometry import Geometry
from pseudocylindrical_convolution_torch.models.cmpnet import (
    CMPNet, CMPNetConfig)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("npart,h,w,G", [(4, 2, 16, 2), (16, 4, 128, 48)])
def test_cuda_kernel_matches_plain(cuda, dtype, npart, h, w, G):
    """Bit-equal to the plain version at every step (all 238 at the
    flagship shape), for both widths (the tiny shape's CC = 18 and 2 take
    the kernel's one-element path), on random buffers of B=2 images and on
    buffers holding -0.0 at every patch source row."""
    geom = Geometry(npart=npart)
    _, _, nsteps = wavefront_schedule(geom, h, w, G)
    tabs = wk.build_window_tables(geom, h, w, G, nsteps, dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for CC in (9 * G, G):
        buf = torch.randn((2, tabs.Sbuf, CC), generator=gen,
                          device=cuda).to(dtype)
        negzero = buf.clone()
        negzero[:, tabs.idx6[tabs.wgt6 != 0].long()] = -0.0
        for b in (buf, negzero):
            bad = 0
            for z in range(nsteps):
                got = wk.window_cuda(b, z, tabs)
                want = wk.window_plain(b, z, tabs)
                bad += int((got.view(bits) != want.view(bits)).sum())
            torch.cuda.synchronize()
            assert bad == 0, (CC, bad)


@pytest.mark.gpu
def test_cuda_kernel_unaligned_buffer(cuda):
    """A buffer that is not 16-byte aligned takes the one-element path,
    with the same bits, at the flagship shape."""
    geom = Geometry(npart=16)
    h, w, G = 4, 128, 48
    _, _, nsteps = wavefront_schedule(geom, h, w, G)
    tabs = wk.build_window_tables(geom, h, w, G, nsteps, torch.bfloat16,
                                  cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    CC = 9 * G
    flat = torch.randn(tabs.Sbuf * CC + 1, generator=gen,
                       device=cuda).to(torch.bfloat16)
    buf = flat[1:].view(1, tabs.Sbuf, CC)
    assert buf.data_ptr() % 16
    for z in (0, nsteps // 2, nsteps - 1):
        got = wk.window_cuda(buf, z, tabs)
        want = wk.window_plain(buf, z, tabs)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), z


@pytest.mark.gpu
def test_window_and_fused_calls_are_one_launch(cuda):
    """A window_cuda or fused_cuda call runs one device kernel and nothing
    else: no patch values or other torch kernels beside it."""
    from torch.profiler import ProfilerActivity, profile
    tabs, nsteps, ops = _fused_operands(cuda, torch.bfloat16, 16, 4, 128,
                                        48, 15)
    for buf, k in ops:
        wk.window_cuda(buf, 1, tabs)
        fk.fused_cuda(buf, 1, tabs, k)
        torch.cuda.synchronize()
        for call, name in ((lambda: wk.window_cuda(buf, 1, tabs),
                            "window_kernel"),
                           (lambda: fk.fused_cuda(buf, 1, tabs, k),
                            "fused_kernel")):
            for _ in range(3):      # the tracer drops an event now and then
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    call()
                    torch.cuda.synchronize()
                ran = [e.key for e in prof.key_averages()
                       if e.self_device_time_total > 0]
                if ran:
                    break
            assert len(ran) == 1 and name in ran[0], ran


def _fused_operands(cuda, dtype, npart, h, w, G, seed):
    geom = Geometry(npart=npart)
    _, _, nsteps = wavefront_schedule(geom, h, w, G)
    tabs = wk.build_window_tables(geom, h, w, G, nsteps, dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ops = []
    for CC, CI in ((9 * G, 3 * G), (G, G)):
        buf = torch.randn((1, tabs.Sbuf, CC), generator=gen,
                          device=cuda).to(dtype)
        k = (torch.randn((3 * G, 45 * CI, 3), generator=gen, device=cuda)
             / (45 * CI) ** 0.5).to(dtype)
        ops.append((buf, k))
    return tabs, nsteps, ops


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("npart,h,w,G", [(4, 2, 16, 2), (16, 4, 128, 48)])
def test_fused_kernel_matches_plain(cuda, dtype, npart, h, w, G):
    """Within the module's tolerance of the plain version at every step,
    for the hidden-layer and input-plane widths, on random buffers
    (margins and trash row included)."""
    tabs, nsteps, ops = _fused_operands(cuda, dtype, npart, h, w, G, 11)
    for buf, k in ops:
        bad = 0
        for z in range(nsteps):
            got = fk.fused_cuda(buf, z, tabs, k)
            want = fk.fused_plain(buf, z, tabs, k)
            tol = fk.fused_tolerance(buf, z, tabs, k)
            bad += int(((got - want).abs() > tol).sum())
        torch.cuda.synchronize()
        assert bad == 0, (buf.shape[2], bad)


def _ordered_mismatches(tabs, nsteps, buf, k):
    """Cells where the kernel and fused_ordered differ, over every step."""
    bad = 0
    for z in range(nsteps):
        got = fk.fused_cuda(buf, z, tabs, k)
        want = fk.fused_ordered(buf, z, tabs, k)
        bad += int((got.view(torch.int32) != want.view(torch.int32)).sum())
    torch.cuda.synchronize()
    return bad


@pytest.mark.gpu
@pytest.mark.parametrize("npart,h,w,G", [(4, 2, 16, 2), (16, 4, 128, 48)])
def test_fused_kernel_matches_ordered(cuda, npart, h, w, G):
    """Bit for bit the plain version in the kernel's own sum order
    (bf16), at every step, for both widths."""
    tabs, nsteps, ops = _fused_operands(cuda, torch.bfloat16, npart, h, w,
                                        G, 13)
    for buf, k in ops:
        assert _ordered_mismatches(tabs, nsteps, buf, k) == 0, buf.shape[2]


@pytest.mark.gpu
def test_fused_kernel_short_chunks(cuda):
    """G = 8 output groups are not a multiple of the groups per block, so
    the last chunk of groups of each subnet is short: still bit for bit the
    ordered plain version, and within tolerance of fused_plain."""
    npart, h, w, G = 10, 4, 64, 8
    tabs, nsteps, ops = _fused_operands(cuda, torch.bfloat16, npart, h, w,
                                        G, 14)
    for buf, k in ops:
        CC, CI = buf.shape[2], k.shape[1] // 45
        info = fk.kernel_info(torch.bfloat16, tabs, CC, CI, k.shape[2])
        assert G % info["groups_per_block"], info
        assert _ordered_mismatches(tabs, nsteps, buf, k) == 0, CC
        for z in (0, nsteps // 2, nsteps - 1):
            err = (fk.fused_cuda(buf, z, tabs, k)
                   - fk.fused_plain(buf, z, tabs, k)).abs()
            assert (err <= fk.fused_tolerance(buf, z, tabs, k)).all(), (CC,
                                                                         z)


@pytest.mark.gpu
def test_fused_kernel_repeats_bit_for_bit(cuda):
    tabs, nsteps, ops = _fused_operands(cuda, torch.bfloat16, 16, 4, 128,
                                        48, 12)
    for buf, k in ops:
        a = fk.fused_cuda(buf, nsteps // 2, tabs, k)
        b = fk.fused_cuda(buf, nsteps // 2, tabs, k)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_fused_profile_roundtrip_on_card(cuda):
    """The fused profile's encode -> decode on the card at the tiny
    configuration: equal symbols, and every layer-step a kernel launch."""
    cfg = CMPNetConfig(valid_dim=8, channels=8, code_channels=8, npart=4)
    geom = cfg.geometry()
    h, w, B = 2, 16, 2
    model = CMPNet(cfg).init_random(torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    codec = ScanWavefrontCodec(cfg, geom, h, w, batch=B, lanes=4,
                               device=cuda, window_mode="fused")
    codec.prepare(model.ent)
    planes = np.random.default_rng(5).integers(
        0, 8, (B, geom.npart, cfg.ngroup, h, w))
    valid = np.zeros(planes.shape[1:], bool)
    for b, wl in enumerate(geom.hindex(h * geom.npart, w)):
        valid[b, :, :, :int(wl)] = True
    before = fk.launches
    dec = codec.decode_streams(codec.encode_planes(planes))
    assert ((dec == planes) | ~valid[None]).all()
    assert fk.launches - before == 2 * 12 * codec.nsteps
