#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port: builds, checks and times it.

  python3 chip_smoke.py [--profile]

Needs one CUDA card and the repository around it; exits non-zero, with no
result line, on a machine without a card or run from a directory that does
not hold the port. Phases, each printing one flushed JSON line with its
seconds:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: window.cu and fused.cu (nvcc, sm_90a) and coder.cpp (g++),
     started together; the ptxas lines of the two kernels;
  3. kernel: the skew-window kernel against its plain version at the
     flagship shapes (B=1, npart=16, h=4, T=56, CC=432 and CC=48), bit for
     bit at every step on a seeded random bf16 buffer (and the plain
     version built from the kernel's own tables, window_from_tables, bit
     for bit too); one device kernel per call; then timed (CUPTI device
     time of the kernel and of the whole call, host wall per call) beside
     the plain version, one torch.index_select of the tap-0 rows (a floor:
     it gathers less than the window; the port never calls it) and its
     bound;
  4. fused_kernel: the fused window+conv kernel against its plain version
     at the same shapes (CI=144 and CI=48, cout3=432) and steps, with a
     seeded random bf16 K, within the module's stated tolerance, and bit
     for bit against fused_ordered (the plain version in the kernel's own
     sum order); its bands and groups per block, registers and shared
     memory per block; two launches bit-identical; one device kernel
     per call; timed beside the plain version, the window profile's
     torch.bmm on pre-gathered taps (a yardstick for the conv half only,
     which the fused profile never calls) and its bound;
  5. codec: the flagship MSE model (demo/mse/10_192.pkl through the port's
     loader; a checkout without it fails here) encodes and decodes one
     smooth 512x1024 image through scan_encode_images / scan_decode_images
     (the default window profile); the decoded symbol planes must equal
     the encoded ones, and the window kernel must have launched exactly
     2 x 12 x nsteps times and the fused kernel never; the stream's
     bytes and sha256;
  6. fused_codec: the same planes through get_scan_codec(...,
     window_mode="fused").encode_files and scan_decode_images, which
     picks the profile from the header; equal symbol planes, flags2 =
     FLAG2_TORCH | FLAG2_TORCH_FUSED, exactly 2 x 12 x nsteps fused
     launches and no window launch, and the same reconstruction; the
     stream's bytes and sha256;
  7. dense_codec: the same image through the dense mode,
     pipeline.encode_images / decode_image (no kernel of ours: the
     network is gathers and fp32 matmuls); the decoded symbol planes
     must equal the encoded ones and the scan encode's, the header must
     say MODE_DENSE with FLAG2_TORCH, neither kernel may launch, and the
     reconstruction must equal the window profile's; encode and decode
     seconds, bytes, sha256, bpp, and how many of the encoder's CDF rows
     would differ had it built them all at once instead of in each
     step's maxlen window as the decoder does (information: both sides
     build them per step);
  8. incr_codec: the same for the incremental mode,
     incremental.incr_encode_images / incr_decode_images and MODE_INCR;
  9. cli_test: the smooth image as an 8-bit .npy through cli.main at
     --model-idx 9: --enc in the scan, dense and incremental modes,
     --test of the dense stream (its bpp, viewport PSNR and SSIM, and
     WS-PSNR), and --dec of each stream; the three decoded .npy files
     must be equal (one encoder made the latents);
 10. train_parity: one micro-batch of the trainer's loss and every
     parameter gradient at the tiny config (vd 8, ch 8, npart 4, 64x128,
     seeded weights and images) on the card and on the CPU, in float32
     and in float64, each within rtol 1e-4 and 1e-6 x max|g| per tensor;
     the worst element of each;
 11. train: train.loop.run at the flagship width (vd 192, npart 16) from
     demo/mse/10_192.pkl through --init-from, --batch-size 4 --acc-batch
     3, 12 train and 4 test 512x1024 .npy images made from smooth_image,
     2 epochs (the E/D phase, then the entropy phase, each validated and
     saved); every loss finite, the entropy net and its Adam state
     bit-identical through the E/D epoch, encoder/decoder/quant and
     their Adam state through the entropy epoch, count moved, step 2 (a
     smaller micro-batch only if 4 does not fit, with the peak memory of
     each size tried); then make_train_step with check_iters=1, one
     warm-up and 3 timed macro-steps per phase: seconds per macro-step
     (median), images per second, peak memory;
 12. train_resume: in a child process with CUBLAS_WORKSPACE_CONFIG set
     and torch.use_deterministic_algorithms(True), 4 macro-steps at the
     flagship width (256x512 images, batch 1, acc 2, check_iters 2,
     phases alternating) without a stop, against 2 steps, a saved and
     loaded train state and 2 more: parameters, count and both Adam
     states bit-equal (or, if torch refuses an op in that mode, the op
     named and the runs held to allclose with the worst difference);
 13. train_codec: the _final.pkl that run() wrote, loaded with
     load_model, encodes and decodes one image through the scan codec's
     window profile with 0 symbol mismatches and 2 x 12 x nsteps window
     kernel launches.

With --profile, one more encode of the same plane per profile runs under
torch.profiler and a "profile" line gives its kernels by device time;
in phase 11 one more macro-step per phase does, in a "train_profile"
line.
Then a {"kernels": [...]} line, the nvidia-smi line again, and last
{"ok": true, "device": {...}}. Any failed check raises.
"""

from __future__ import annotations

import concurrent.futures
import gc
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # ... dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # ... fp32 outside the tensor cores
CHECKPOINT = os.path.join("demo", "mse", "10_192.pkl")
T_START = time.time()


def emit(phase: str, t0: float, **kv) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3),
                      **kv}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50) -> float:
    """Wall time per call between CUDA events (host-bound when the calls
    are shorter than their launch overhead)."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 50, only: str | None = None,
                   tries: int = 8) -> tuple[float, float]:
    """Device time and kernel launches per call: the summed time and the
    count of the CUDA kernels one call runs (those whose name holds
    ``only``, if given), from torch.profiler's CUPTI trace. Every kernel a
    call runs, runs a whole number of times per call, so a trace in which
    a kernel was not recorded a whole multiple of ``iters`` times (the
    tracer drops events now and then) is taken again; raises after
    ``tries`` such traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0
              and (only is None or only in e.key)]
        if ev and all(e.count % iters == 0 for e in ev):
            return (sum(e.self_device_time_total for e in ev) / 1e3 / iters,
                    sum(e.count for e in ev) / iters)
    raise AssertionError(f"the profiler recorded no complete trace in "
                         f"{tries} tries; the last counted "
                         f"{[(e.key[:60], e.count) for e in ev]} over "
                         f"{iters} calls")


def device_ms(fn, iters: int = 50, only: str | None = None) -> float:
    """Device time per call (``device_profile``)."""
    return device_profile(fn, iters, only)[0]


def kernel_phase(wk, geom, G, h, w, nsteps):
    """Bit-compare and time the window kernel at both channel widths."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    tabs = wk.build_window_tables(geom, h, w, G, nsteps, torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    shapes = {}
    for CC in (3 * G * 3, G):
        buf = torch.randn((1, tabs.Sbuf, CC), generator=gen, device=dev
                          ).to(torch.bfloat16)
        bad, tab_bad, maxerr = 0, 0, 0.0
        for z in range(nsteps):
            got = wk.window_cuda(buf, z, tabs)
            want = wk.window_plain(buf, z, tabs)
            tab = wk.window_from_tables(buf, z, tabs)
            torch.cuda.synchronize()
            bad += int((got.view(torch.int16) != want.view(torch.int16))
                       .sum())
            tab_bad += int((tab.view(torch.int16) != want.view(torch.int16))
                           .sum())
            maxerr = max(maxerr, float((got.float() - want.float()).abs()
                                       .max()))
        if bad or tab_bad:
            raise AssertionError(f"window kernel differs from its plain "
                                 f"version in {bad} elements at CC={CC}; "
                                 f"the table-driven plain version in "
                                 f"{tab_bad}")
        # timed at the step earlier smokes timed: the middle one of 12
        # spread over the steps
        zt = int(np.linspace(0, nsteps - 1, 12).round()[6])
        # the rows of tap 0, the gather a library call can do in one go
        cp = tabs.cp_base + zt
        cc = torch.where((cp < 0) | (cp >= w + 4), w + 4, cp)
        rows = torch.gather(tabs.idx[0], 2, cc).reshape(-1)
        flat = buf[0]
        nbytes = wk.window_bytes(buf, zt, tabs)

        def kern():
            return wk.window_cuda(buf, zt, tabs)

        def plain():
            return wk.window_plain(buf, zt, tabs)

        def library():
            return torch.index_select(flat, 0, rows)

        wrapper_ms, per_call = device_profile(kern)
        if per_call != 1:
            raise AssertionError(f"a window_cuda call ran {per_call} device "
                                 f"kernels at CC={CC}, expected 1")
        shapes[CC] = {
            "mismatches": bad, "table_plain_mismatches": tab_bad,
            "max_abs_err": maxerr, "steps": nsteps,
            "ms": device_ms(kern, only="window_kernel"),
            "wrapper_device_ms": wrapper_ms,
            "launches_per_call": per_call,
            "wrapper_call_ms": cuda_ms(kern),
            "plain_ms": device_ms(plain),
            "plain_call_ms": cuda_ms(plain),
            "library_ms": device_ms(library),
            "library_is": "floor: index_select of the tap-0 rows only",
            "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    return shapes


def fused_kernel_phase(fk, wk, wavefront_scan, geom, G, h, w, nsteps):
    """Compare, repeat and time the fused kernel at both input widths."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    tabs = wk.build_window_tables(geom, h, w, G, nsteps, torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(4321)
    zs = sorted(set(np.linspace(0, nsteps - 1, 12).round().astype(int)))
    n = 3
    shapes = {}
    for CC in (3 * G * 3, G):
        CI = CC // 3 if CC != G else G
        buf = torch.randn((1, tabs.Sbuf, CC), generator=gen, device=dev
                          ).to(torch.bfloat16)
        k = (torch.randn((3 * G, 45 * CI, n), generator=gen, device=dev)
             / math.sqrt(45 * CI)).to(torch.bfloat16)
        bad, ord_bad, max_abs, max_rel = 0, 0, 0.0, 0.0
        for z in zs:
            got = fk.fused_cuda(buf, int(z), tabs, k)
            want = fk.fused_plain(buf, int(z), tabs, k)
            tol = fk.fused_tolerance(buf, int(z), tabs, k)
            ordered = fk.fused_ordered(buf, int(z), tabs, k)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"fused kernel gave non-finite cells "
                                     f"at CI={CI}, step {z}")
            ord_bad += int((got.view(torch.int32)
                            != ordered.view(torch.int32)).sum())
            err = (got - want).abs()
            bad += int((err > tol).sum())
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err * fk.TOL / tol.clamp_min(
                1e-30)).max()))
        if bad:
            raise AssertionError(
                f"fused kernel differs from its plain version beyond "
                f"{fk.TOL} x sum|products| in {bad} cells at CI={CI} "
                f"(max abs err {max_abs})")
        if ord_bad:
            raise AssertionError(
                f"fused kernel differs from fused_ordered (its own sum "
                f"order) in {ord_bad} cells at CI={CI}")
        zt = int(zs[len(zs) // 2])
        a = fk.fused_cuda(buf, zt, tabs, k)
        b = fk.fused_cuda(buf, zt, tabs, k)
        torch.cuda.synchronize()
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"two fused launches differ at CI={CI}")
        # the window profile's conv half: one bmm on pre-gathered taps, with
        # the same K in that profile's layout (batch u = G-1-g)
        nb = 3 if CC != G else 1
        kg = k.float().reshape(3, G, 45 * CI, n).flip(1)
        kwin = (kg.permute(1, 0, 2, 3).reshape(3 * G, 45 * CI, n) if nb == 3
                else kg.permute(1, 2, 0, 3).reshape(G, 45 * CI, 3 * n))
        taps = wavefront_scan.conv_taps(wk.window_plain(buf, zt, tabs), nb)
        nbytes = fk.fused_bytes(buf, zt, tabs, k)
        flops = fk.fused_flops(buf, tabs, k)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3

        def kern():
            return fk.fused_cuda(buf, zt, tabs, k)

        def plain():
            return fk.fused_plain(buf, zt, tabs, k)

        def library():
            return torch.bmm(taps, kwin)

        wrapper_ms, per_call = device_profile(kern)
        if per_call != 1:
            raise AssertionError(f"a fused_cuda call ran {per_call} device "
                                 f"kernels at CI={CI}, expected 1")
        shapes[CC] = {
            **fk.kernel_info(torch.bfloat16, tabs, CC, CI, n),
            "CI": CI, "mismatches": bad, "ordered_mismatches": ord_bad,
            "max_abs_err": max_abs,
            "max_err_over_abs_sum": max_rel, "tolerance": fk.TOL,
            "steps": len(zs), "repeat_bit_identical": True,
            "ms": device_ms(kern, only="fused_kernel"),
            "wrapper_device_ms": wrapper_ms, "launches_per_call": per_call,
            "wrapper_call_ms": cuda_ms(kern),
            "plain_ms": device_ms(plain, iters=10),
            "library_ms": device_ms(library),
            "library_is": "torch.bmm of the window profile on pre-gathered "
                          "taps: the conv half only",
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return shapes


def ptxas_lines(lib_path: str) -> list[str]:
    """What nvcc -Xptxas -v printed of each kernel: its name, then its
    registers and barriers."""
    with open(lib_path[:-3] + ".log") as f:
        return [ln.strip() for ln in f
                if "entry function" in ln or "registers" in ln]


def profile_phase(codec, planes, wall_s: float, kernel: str,
                  launches: int, tries: int = 3) -> None:
    """Where a teacher-mode (encode) run of the step loop spends device
    time: kernels by summed device time, and the device's busy share of
    the unprofiled encode's wall time. A trace that did not record all
    ``launches`` of ``kernel`` (the tracer drops events now and then) is
    taken again; raises after ``tries`` such traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    teacher = torch.as_tensor(planes).to("cuda").reshape(1, codec.P)
    for _ in range(tries):
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            codec.run(teacher=teacher)
            torch.cuda.synchronize()
        ev = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages() if e.self_device_time_total > 0]
        if sum(c for k, _, c in ev if kernel in k) == launches:
            break
    else:
        raise AssertionError(f"the profiler missed launches of {kernel} "
                             f"in {tries} tries")
    busy = sum(t for _, t, _ in ev) / 1e3
    top = sorted(ev, key=lambda e: -e[1])[:15]
    emit("profile", t0, window_mode=codec.window_mode, busy_s=busy,
         busy_share_of_encode=busy / wall_s,
         top=[{"kernel": k[:90], "ms": t, "calls": c} for k, t, c in top])


def mode_phase(phase, encode, decode, mode, model, geom, x, ref, wk, fk,
               container, extra=None) -> None:
    """One image through a mode's encode and decode entry points, with
    neither kernel launched; the symbols and the reconstruction must be
    the scan codec's (``ref`` = its symbol planes, validity mask and
    reconstruction)."""
    import numpy as np
    import torch
    t_phase = time.time()
    planes, valid, rec = ref
    H, W = x.shape[2:]
    with tempfile.TemporaryDirectory() as tmp:
        fn = os.path.join(tmp, "img.bin")
        wk.launches = fk.launches = 0
        t0 = time.time()
        (size,), eplanes = encode(model, [x], geom, [fn], device="cuda",
                                  return_planes=True)
        torch.cuda.synchronize()
        t_enc = time.time() - t0
        t0 = time.time()
        drec, dplanes = decode(model, geom, [fn], (H, W), device="cuda",
                               return_planes=True)
        torch.cuda.synchronize()
        t_dec = time.time() - t0
        stray = wk.launches + fk.launches
        hdr = container.read_stream(fn)
        digest = sha256_of(fn)
    nbad = int(((dplanes != eplanes) & valid[None]).sum())
    if nbad:
        raise AssertionError(f"{phase}: decoded symbol plane differs in "
                             f"{nbad} symbols")
    if not np.array_equal(eplanes, planes):
        raise AssertionError(f"{phase}: the encoder's latents differ from "
                             f"the scan encode's")
    if (hdr["mode"], hdr["flags2"]) != (mode, container.FLAG2_TORCH):
        raise AssertionError(f"{phase}: header mode {hdr['mode']}, flags2 "
                             f"{hdr['flags2']}")
    if stray:
        raise AssertionError(f"{phase}: {stray} window or fused kernel "
                             f"launches, expected 0")
    drec = drec.float().cpu().numpy()
    if drec.shape != x.shape or not np.isfinite(drec).all():
        raise AssertionError(f"{phase}: bad reconstruction {drec.shape}")
    if not np.array_equal(drec, rec):
        raise AssertionError(f"{phase}: the reconstruction differs from the "
                             f"scan codec's on the same latents")
    emit(phase, t_phase, encode_s=round(t_enc, 3),
         decode_s=round(t_dec, 3), bytes=size, sha256=digest,
         bpp=size * 8 / (H * W), symbol_mismatches=nbad,
         kernel_launches=stray, **(extra or {}))


def dense_phase(model, geom, x, ref, wk, fk, container) -> None:
    """Phase 7; also counts the CDF rows that a one-shot table would
    change against the per-step windows both sides build."""
    import torch
    from pseudocylindrical_convolution_torch.codec import pipeline as pl
    from pseudocylindrical_convolution_torch.models.entropy import (
        fused_weights)
    from pseudocylindrical_convolution_torch.ops.gmm_table import (
        gmm_cdf_table)
    planes = ref[0]
    sched = pl._Schedule(geom, *planes.shape[3:], model.cfg.ngroup, "cuda")
    layers = fused_weights(model.ent, model.cfg.ngroup)
    biased = torch.as_tensor(planes, device="cuda").float() - pl.BIAS
    step_rows = pl._table_body(layers, biased, geom, sched)[0]
    raw = pl._raw_rows(layers, biased[0], geom)[
        :, sched.flat_pad[:sched.flat.shape[0]]]
    full = gmm_cdf_table(raw[0], raw[1], raw[2], pl.NSTEP, pl.BIAS, pl.TOTAL)
    differ = int((full != step_rows).any(dim=1).sum())
    mode_phase("dense_codec", pl.encode_images, pl.decode_image,
               container.MODE_DENSE, model, geom, x, ref, wk, fk, container,
               {"nsteps": sched.nsteps, "maxlen": sched.maxlen,
                "full_table_rows_differing": differ,
                "rows": int(step_rows.shape[0])})


def incr_phase(model, geom, x, ref, wk, fk, container) -> None:
    """Phase 8."""
    from pseudocylindrical_convolution_torch.codec import incremental
    mode_phase("incr_codec", incremental.incr_encode_images,
               incremental.incr_decode_images, container.MODE_INCR, model,
               geom, x, ref, wk, fk, container)


def cli_phase(x) -> None:
    """Phase 9: the CLI on .npy files through the registry."""
    import contextlib
    import io
    import numpy as np
    from pseudocylindrical_convolution_torch import cli
    t_phase = time.time()
    img = np.round(x[0].transpose(1, 2, 0) * 255.0).astype(np.uint8)
    log = io.StringIO()
    secs = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(
            log):
        src = os.path.join(tmp, "img.npy")
        np.save(src, img)
        outs = []
        for mode in ("scan", "dense", "incremental"):
            code = os.path.join(tmp, f"{mode}.bin")
            out = os.path.join(tmp, f"{mode}.npy")
            t0 = time.time()
            cli.main(["--enc", "--img-list", src, "--code-list", code,
                      "--mode", mode, "--model-idx", "9"])
            secs[f"{mode}_enc_s"] = round(time.time() - t0, 3)
            if mode == "dense":
                t0 = time.time()
                metrics = cli.main(["--test", "--code-list", code,
                                    "--img-list", src, "--model-idx", "9"])
                secs["dense_test_s"] = round(time.time() - t0, 3)
            t0 = time.time()
            cli.main(["--dec", "--code-list", code, "--out-list", out,
                      "--model-idx", "9"])
            secs[f"{mode}_dec_s"] = round(time.time() - t0, 3)
            outs.append(np.load(out))
    for mode, out in zip(("dense", "incremental"), outs[1:]):
        if not np.array_equal(out, outs[0]):
            raise AssertionError(f"cli_test: the {mode} stream decodes to "
                                 f"another image than the scan stream")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"cli_test: --test gave {metrics}")
    emit("cli_test", t_phase, test=metrics, outputs_equal=True, **secs,
         test_lines=[ln.strip() for ln in log.getvalue().splitlines()
                     if "Bitrate:" in ln])


def sha256_of(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def smooth_image(seed: int = 0, hw=(512, 1024)):
    """A smooth RGB test image in [0, 1]: a few low-frequency waves."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, hw[0])[:, None]
    x = np.linspace(0, 1, hw[1])[None, :]
    img = np.zeros((3,) + hw)
    for c in range(3):
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 4, 2)
            ph = rng.uniform(0, 2 * math.pi)
            img[c] += rng.uniform(0.05, 0.15) * np.sin(
                2 * math.pi * (fy * y + fx * x) + ph)
        img[c] += 0.5
    return np.clip(img, 0, 1)[None].astype(np.float32)


TRAIN_IMAGES, TEST_IMAGES = 12, 4
RESUME_CHILD = "--train-resume-child"


def _grads(model, x, cfg, geom, lw):
    """Loss and every parameter gradient (float64, on the CPU) of one
    micro-batch of the trainer's loss."""
    from pseudocylindrical_convolution_torch.parallel.train import (
        _loss_terms)
    loss, _ = _loss_terms(model, x, cfg, geom, lw)
    loss.backward()
    return loss.item(), {n: p.grad.detach().double().cpu()
                         for n, p in model.named_parameters()}


def train_parity_phase() -> None:
    """Phase 10: the card's gradients against the CPU's, tiny config."""
    import numpy as np
    import torch
    from pseudocylindrical_convolution_torch.models.cmpnet import (
        CMPNet, CMPNetConfig)
    from pseudocylindrical_convolution_torch.parallel.train import (
        LossWeights)
    t0 = time.time()
    cfg = CMPNetConfig(valid_dim=8, channels=8, code_channels=8, npart=4)
    geom, lw = cfg.geometry(), LossWeights(viewport_size=17)
    x = np.random.default_rng(7).uniform(size=(2, 3, 64, 128)).astype(
        np.float32)
    report, bad = {}, []
    rel = 1e-6
    for dtype in (torch.float64, torch.float32):
        res = {}
        for dev in ("cpu", "cuda"):
            model = CMPNet(cfg).init_random(
                torch.Generator().manual_seed(3)).to(dev, dtype)
            res[dev] = _grads(model, torch.as_tensor(x).to(dev, dtype), cfg,
                              geom, lw)
        (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
        worst = {"ratio": 0.0}
        for name, want in gc.items():
            got = gg[name]
            tol = rel * float(want.abs().max()) + 1e-4 * want.abs()
            err = (got - want).abs()
            ratio = torch.where(tol > 0, err / tol.clamp_min(1e-300),
                                torch.where(err > 0, torch.inf, 0.0))
            i = int(ratio.argmax())
            if float(ratio.reshape(-1)[i]) >= worst["ratio"]:
                worst = {"ratio": float(ratio.reshape(-1)[i]),
                         "tensor": name, "index": i,
                         "card": float(got.reshape(-1)[i]),
                         "cpu": float(want.reshape(-1)[i]),
                         "max_abs_g": float(want.abs().max())}
        key = str(dtype).split(".")[-1]
        report[key] = {"loss_card": lg, "loss_cpu": lc,
                       "atol_over_max_g": rel, "rtol": 1e-4,
                       "worst": worst, "tensors": len(gc)}
        if worst["ratio"] > 1 or not math.isclose(lg, lc, rel_tol=1e-4):
            bad.append(key)
    emit("train_parity", t0, **report)
    if bad:
        raise AssertionError(f"train_parity: the card's loss or gradients "
                             f"leave the tolerance in {bad}: {report}")


def train_flops(cfg, batch: int, hw) -> dict:
    """Operations of one micro-batch's loss and backward per phase
    ("ed", "ent"), counted by torch's flop counter on meta tensors."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from pseudocylindrical_convolution_torch.models.cmpnet import CMPNet
    from pseudocylindrical_convolution_torch.parallel.train import (
        LossWeights, _loss_terms)
    model = CMPNet(cfg).to("meta")
    x = torch.empty((batch, 3, *hw), device="meta")
    out = {}
    for phase in ("ed", "ent"):
        for n, p in model.named_parameters():
            p.requires_grad_(n.startswith("ent.") == (phase == "ent"))
        counter = FlopCounterMode(display=False)
        with counter:
            loss, _ = _loss_terms(model, x, cfg, cfg.geometry(),
                                  LossWeights())
            loss.backward()
        out[phase] = counter.get_total_flops()
    return out


def _write_npy_images(d: str, seeds, hw) -> list:
    import numpy as np
    os.makedirs(d, exist_ok=True)
    names = []
    for s in seeds:
        img = np.round(smooth_image(s, hw)[0].transpose(1, 2, 0) * 255.0)
        names.append(f"s{s}.npy")
        np.save(os.path.join(d, names[-1]), img.astype(np.uint8))
    return names


def train_phase(tmp: str):
    """Phase 11; returns the save directory of the run."""
    import numpy as np
    import torch
    from pseudocylindrical_convolution_torch.parallel.train import (
        LossWeights, make_train_step)
    from pseudocylindrical_convolution_torch.train import loop
    from pseudocylindrical_convolution_torch.train.dataset import (
        SphereDataset, batch_iterator)
    from pseudocylindrical_convolution_torch.utils.checkpoint import (
        _nested_to_flat, load_param_tree)
    t_phase = time.time()
    hw = (512, 1024)
    img_dir = os.path.join(tmp, "imgs")
    train = _write_npy_images(img_dir, range(100, 100 + TRAIN_IMAGES), hw)
    test = _write_npy_images(img_dir, range(200, 200 + TEST_IMAGES), hw)
    for fn, names in (("train.txt", train), ("test.txt", test)):
        with open(os.path.join(tmp, fn), "w") as f:
            f.write("\n".join(names) + "\n")
    ent0 = {f"ent.{k}": v for k, v in _nested_to_flat(
        load_param_tree(CHECKPOINT)["ent"]).items()}
    rec = {"loss": [], "mse": [], "rate": [], "phase": []}

    def on_step(epoch, bi, train_ent, state, m):
        for k in ("loss", "mse", "rate"):
            rec[k].append(float(m[k]))
        rec["phase"].append("ent" if train_ent else "ed")
        params = dict(state.model.named_parameters())
        if not train_ent:
            for n, v in ent0.items():
                if not np.array_equal(params[n].detach().cpu().numpy(), v):
                    raise AssertionError(f"train: {n} changed in the E/D "
                                         f"phase")
            if state.opt_ent.state:
                raise AssertionError("train: the entropy Adam state moved "
                                     "in the E/D phase")
            rec["ed_params"] = {n: p.detach().clone()
                                for n, p in params.items()
                                if not n.startswith("ent.")}
            rec["ed_adam"] = _adam_copy(state.opt_other)
        else:
            for n, v in rec["ed_params"].items():
                if not torch.equal(params[n], v):
                    raise AssertionError(f"train: {n} changed in the "
                                         f"entropy phase")
            if not _adam_equal(state.opt_other, rec["ed_adam"]):
                raise AssertionError("train: the E/D Adam state moved in "
                                     "the entropy phase")

    tried = []
    for bs in (4, 2, 1):
        save = os.path.join(tmp, f"save_b{bs}")
        args = loop.build_argparser().parse_args([
            "--img-dir", img_dir,
            "--train-list", os.path.join(tmp, "train.txt"),
            "--test-list", os.path.join(tmp, "test.txt"),
            "--init-from", CHECKPOINT, "--batch-size", str(bs),
            "--acc-batch", "3", "--test-batch-size", "4", "--epochs", "2",
            "--log-every", "1", "--save-dir", save, "--device", "cuda"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        try:
            state = loop.run(args, on_step=on_step)
        except torch.cuda.OutOfMemoryError:
            tried.append({"batch_size": bs, "fits": False,
                          "peak_bytes": torch.cuda.max_memory_allocated()})
            for k in rec:
                rec[k] = [] if isinstance(rec[k], list) else None
            gc.collect()
            torch.cuda.empty_cache()
            continue
        torch.cuda.synchronize()
        run_s = time.time() - t0
        tried.append({"batch_size": bs, "fits": True,
                      "peak_bytes": torch.cuda.max_memory_allocated()})
        break
    else:
        raise AssertionError(f"train: no micro-batch size fits: {tried}")
    steps_per_epoch = TRAIN_IMAGES // (bs * 3)
    if not all(math.isfinite(v) for k in ("loss", "mse", "rate")
               for v in rec[k]):
        raise AssertionError(f"train: a loss is not finite: {rec['loss']}")
    if rec["phase"] != ["ed"] * steps_per_epoch + ["ent"] * steps_per_epoch:
        raise AssertionError(f"train: phases {rec['phase']}")
    if state.step != 2 * steps_per_epoch or not bool(state.count.any()):
        raise AssertionError(f"train: step {state.step}, count moved "
                             f"{bool(state.count.any())}")
    saved = sorted(os.listdir(save))
    run_steps = state.step

    # the step alone, maintenance every step (check_iters=1)
    step = make_train_step(state.model.cfg, state.model.cfg.geometry(),
                           LossWeights(), acc_batch=3, check_iters=1)
    ds = SphereDataset(img_dir, os.path.join(tmp, "train.txt"))
    macro = torch.as_tensor(next(batch_iterator(
        ds, np.arange(len(ds)), bs, 3)), device="cuda")
    flops = train_flops(state.model.cfg, bs, hw)
    torch.cuda.reset_peak_memory_stats()
    timing = {}
    for train_ent in (False, True):
        secs, losses = [], []
        for i in range(4):                       # 1 warm-up + 3 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, macro, train_ent)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            if i:
                secs.append(time.perf_counter() - t0)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train: step losses {losses}")
        med = statistics.median(secs)
        phase = "ent" if train_ent else "ed"
        timing[phase] = {
            "s_per_macro_step": secs, "median_s": med,
            "images_per_s": 3 * bs / med, "losses": losses,
            "flops": 3 * flops[phase],
            "bound_s": 3 * flops[phase] / FP32_FLOPS,
            "flops_per_s": 3 * flops[phase] / med}
    if "--profile" in sys.argv[1:]:
        for train_ent in (False, True):
            state = train_profile(step, state, macro, train_ent,
                                  timing["ent" if train_ent else "ed"])
    emit("train", t_phase, nvidia_smi=nvidia_smi(), batch_size=bs,
         acc_batch=3, micro_batches_tried=tried, run_s=round(run_s, 3),
         steps=run_steps, losses=rec["loss"], mse=rec["mse"],
         rate=rec["rate"], phases=rec["phase"], files=saved,
         step_timing=timing,
         step_peak_bytes=torch.cuda.max_memory_allocated())
    return save


def train_profile(step, state, macro, train_ent: bool, timed: dict):
    """One more macro-step of a phase under torch.profiler: kernels by
    device time, and the device's busy share of the unprofiled median
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, macro, train_ent)
        torch.cuda.synchronize()
    ev = [(e.key, e.self_device_time_total / 1e3, e.count)
          for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in ev) / 1e3
    top = sorted(ev, key=lambda e: -e[1])[:20]
    emit("train_profile", t0, step_phase="ent" if train_ent else "ed",
         busy_s=busy, busy_share_of_step=busy / timed["median_s"],
         kernels=len(ev), launches=sum(c for _, _, c in ev),
         top=[{"kernel": k[:90], "ms": t, "calls": c} for k, t, c in top])
    return state


def _adam_copy(opt) -> dict:
    return {k: {kk: vv.clone() for kk, vv in v.items()}
            for k, v in opt.state_dict()["state"].items()}


def _adam_equal(opt, ref: dict) -> bool:
    import torch
    st = opt.state_dict()["state"]
    return st.keys() == ref.keys() and all(
        torch.equal(st[k][kk], ref[k][kk]) for k in st for kk in st[k])


def _resume_runs(deterministic: bool) -> dict:
    """The child's two runs: 4 steps straight, and 2 + save/load + 2;
    returns what differs between them."""
    import numpy as np
    import torch
    from pseudocylindrical_convolution_torch.models.cmpnet import (
        CMPNetConfig)
    from pseudocylindrical_convolution_torch.parallel.train import (
        LossWeights, create_train_state, make_train_step)
    from pseudocylindrical_convolution_torch.utils import checkpoint as ck
    from pseudocylindrical_convolution_torch.utils.device import (
        pin_numerics)
    torch.use_deterministic_algorithms(deterministic)
    pin_numerics()
    cfg = CMPNetConfig(valid_dim=192)
    geom = cfg.geometry()
    tree = ck.load_param_tree(CHECKPOINT)
    step = make_train_step(cfg, geom, LossWeights(), acc_batch=2,
                           check_iters=2)
    batches = [torch.as_tensor(np.stack([smooth_image(300 + 2 * i + j,
                                                      (256, 512))
                                         for j in range(2)]),
                               device="cuda") for i in range(4)]

    def fresh():
        model = ck.load_model(tree, cfg, "cuda").requires_grad_(True)
        return create_train_state(model, 1e-4)

    def go(state, idx):
        for i in idx:
            state, _ = step(state, batches[i], i % 2 == 1)
        return state

    ref = go(fresh(), range(4))
    part = go(fresh(), range(2))
    with tempfile.TemporaryDirectory() as tmp:
        fn = os.path.join(tmp, "ts.pkl")
        ck.save_train_state(part, fn)
        again = fresh()
        ck.restore_train_state(again, ck.load_train_state(fn))
    again = go(again, range(2, 4))
    torch.cuda.synchronize()
    pairs = [(f"param {n}", a, b) for (n, a), (_, b) in zip(
        ref.model.state_dict().items(), again.model.state_dict().items())]
    pairs.append(("count", ref.count, again.count))
    for name, oa, ob in (("adam_other", ref.opt_other, again.opt_other),
                         ("adam_ent", ref.opt_ent, again.opt_ent)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        for k in sa:
            for kk in sa[k]:
                pairs.append((f"{name} {k} {kk}", sa[k][kk], sb[k][kk]))
    differ = [n for n, a, b in pairs if not torch.equal(a, b)]
    worst = max((float((a.double() - b.double()).abs().max()), n)
                for n, a, b in pairs)
    return {"tensors": len(pairs), "differing": differ[:20],
            "n_differing": len(differ), "worst_abs_diff": worst[0],
            "worst_tensor": worst[1], "steps": again.step,
            "allclose": all(torch.allclose(a.double(), b.double(),
                                           rtol=1e-5, atol=1e-7)
                            for _, a, b in pairs)}


def train_resume_child() -> int:
    """Phase 12's body, in its own process (the workspace setting has to
    precede CUDA): one JSON line on stdout."""
    t0 = time.time()
    try:
        out = {"deterministic": True, **_resume_runs(True)}
    except RuntimeError as e:
        if "deterministic" not in str(e):
            raise
        out = {"deterministic": False, "refused_op": str(e)[:400],
               **_resume_runs(False)}
    out["seconds"] = round(time.time() - t0, 3)
    print(json.dumps(out), flush=True)
    return 0


def train_resume_phase() -> None:
    """Phase 12: run the child and hold it to its contract."""
    t0 = time.time()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          RESUME_CHILD], env=env, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"train_resume: the child failed "
                             f"({out.returncode}): {out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    emit("train_resume", t0, **res)
    if res["deterministic"] and res["n_differing"]:
        raise AssertionError(f"train_resume: {res['n_differing']} tensors "
                             f"differ after the resume: {res['differing']}")
    if not res["deterministic"] and not res["allclose"]:
        raise AssertionError(f"train_resume: not even allclose: {res}")


def train_codec_phase(save: str, wk) -> None:
    """Phase 13: the trained checkpoint through the window profile."""
    import numpy as np
    import torch
    from pseudocylindrical_convolution_torch.codec import wavefront_scan
    from pseudocylindrical_convolution_torch.codec.wavefront import (
        wavefront_schedule)
    from pseudocylindrical_convolution_torch.models.cmpnet import (
        CMPNetConfig)
    from pseudocylindrical_convolution_torch.utils.checkpoint import (
        load_model)
    t0 = time.time()
    cfg = CMPNetConfig(valid_dim=192)
    geom = cfg.geometry()
    H, W = 512, 1024
    h, w = H // geom.npart // 8, W // 8
    path = os.path.join(save, "ent_opt_192_192_16_final.pkl")
    model = load_model(path, cfg, device="cuda")
    x = smooth_image(0, (H, W))
    with tempfile.TemporaryDirectory() as tmp:
        fn = os.path.join(tmp, "img.bin")
        wk.launches = 0                     # the trained model's path
        (size,), planes = wavefront_scan.scan_encode_images(
            model, [x], geom, [fn], device="cuda", return_planes=True)
        rec, dplanes = wavefront_scan.scan_decode_images(
            model, geom, [fn], (H, W), device="cuda", return_planes=True)
        torch.cuda.synchronize()
        launches = wk.launches              # ... ends here
    _, _, nsteps = wavefront_schedule(geom, h, w, cfg.ngroup)
    valid = np.zeros((geom.npart, cfg.ngroup, h, w), bool)
    for b, wl in enumerate(geom.hindex(h * geom.npart, w)):
        valid[b, :, :, :int(wl)] = True
    nbad = int(((dplanes != planes) & valid[None]).sum())
    rec = rec.float().cpu().numpy()
    mse = float(np.mean((rec - x) ** 2))
    emit("train_codec", t0, weights=os.path.basename(path), bytes=size,
         bpp=size * 8 / (H * W), psnr_db=10 * math.log10(1.0 / max(mse,
                                                                    1e-12)),
         symbol_mismatches=nbad, window_launches=launches)
    if nbad or launches != 2 * 12 * nsteps or not np.isfinite(rec).all():
        raise AssertionError(f"train_codec: {nbad} symbol mismatches, "
                             f"{launches} window launches (expected "
                             f"{2 * 12 * nsteps})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from pseudocylindrical_convolution_torch.codec import (
            coder_bridge, container, fused_kernel as fk, wavefront_scan,
            window_kernel as wk)
        from pseudocylindrical_convolution_torch.codec.wavefront import (
            wavefront_schedule)
        from pseudocylindrical_convolution_torch.models.cmpnet import (
            CMPNetConfig)
        from pseudocylindrical_convolution_torch.utils.checkpoint import (
            load_model)
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 3
    import numpy as np

    t0 = time.time()
    smi = nvidia_smi()
    emit("device", t0, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(wk._load), ex.submit(fk._load),
                ex.submit(coder_bridge.load_library)]
        for f in futs:
            f.result()
    emit("build", t0, ptxas=ptxas_lines(wk._lib._name)
         + ptxas_lines(fk._lib._name))

    cfg = CMPNetConfig(valid_dim=192)
    geom = cfg.geometry()
    H, W = 512, 1024
    h, w = H // geom.npart // 8, W // 8
    _, _, nsteps = wavefront_schedule(geom, h, w, cfg.ngroup)
    t0 = time.time()
    shapes = kernel_phase(wk, geom, cfg.ngroup, h, w, nsteps)
    emit("kernel", t0, shapes={str(k): v for k, v in shapes.items()})

    t0 = time.time()
    wavefront_scan.pin_numerics()
    fshapes = fused_kernel_phase(fk, wk, wavefront_scan, geom, cfg.ngroup,
                                 h, w, nsteps)
    emit("fused_kernel", t0, shapes={str(k): v for k, v in fshapes.items()})

    t0 = time.time()
    if not os.path.exists(CHECKPOINT):
        raise FileNotFoundError(f"the flagship checkpoint {CHECKPOINT} is "
                                f"not in this checkout")
    model = load_model(CHECKPOINT, cfg, device="cuda")
    x = smooth_image(0, (H, W))
    emit("load", t0, weights=CHECKPOINT)

    t_codec = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        fn = os.path.join(tmp, "img.bin")
        wk.launches = fk.launches = 0           # the main path starts here
        t0 = time.time()
        (size,), planes = wavefront_scan.scan_encode_images(
            model, [x], geom, [fn], device="cuda", return_planes=True)
        torch.cuda.synchronize()
        t_enc = time.time() - t0
        t0 = time.time()
        rec, dplanes = wavefront_scan.scan_decode_images(
            model, geom, [fn], (H, W), device="cuda", return_planes=True)
        torch.cuda.synchronize()
        t_dec = time.time() - t0
        launches = wk.launches                  # ... and ends here
        stray = fk.launches
        digest = sha256_of(fn)
    lanes = wavefront_scan.auto_lanes(geom, h, w, cfg.ngroup)
    codec = wavefront_scan.get_scan_codec(cfg, geom, h, w, 1, lanes)
    valid = np.zeros((geom.npart, cfg.ngroup, h, w), bool)
    for b, wl in enumerate(geom.hindex(h * geom.npart, w)):
        valid[b, :, :, :int(wl)] = True
    nbad = int(((dplanes != planes) & valid[None]).sum())
    if nbad:
        raise AssertionError(f"decoded symbol plane differs in {nbad} "
                             f"symbols")
    want = 2 * 12 * nsteps
    if launches != want or stray:
        raise AssertionError(f"window kernel launched {launches} times on "
                             f"the main path, expected {want}; fused "
                             f"kernel {stray}, expected 0")
    rec = rec.float().cpu().numpy()
    if rec.shape != x.shape or not np.isfinite(rec).all():
        raise AssertionError(f"bad reconstruction {rec.shape}")
    mse = float(np.mean((rec - x) ** 2))
    psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
    emit("codec", t_codec, window_mode=codec.window_mode,
         encode_s=round(t_enc, 3), decode_s=round(t_dec, 3),
         bytes=size, sha256=digest, bpp=size * 8 / (H * W), psnr_db=psnr,
         nsteps=nsteps, lanes=codec.L, symbols=codec.nsym,
         symbol_mismatches=nbad, window_launches=launches)

    t_codec = time.time()
    fcodec = wavefront_scan.get_scan_codec(
        cfg, geom, h, w, 1, lanes, window_mode="fused").prepare(model.ent)
    with tempfile.TemporaryDirectory() as tmp:
        fn = os.path.join(tmp, "img.bin")
        wk.launches = fk.launches = 0           # the fused path starts here
        t0 = time.time()
        (fsize,) = fcodec.encode_files(planes, [fn])
        torch.cuda.synchronize()
        f_enc = time.time() - t0
        t0 = time.time()
        frec, fplanes = wavefront_scan.scan_decode_images(
            model, geom, [fn], (H, W), device="cuda", return_planes=True)
        torch.cuda.synchronize()
        f_dec = time.time() - t0
        flaunches, stray = fk.launches, wk.launches   # ... and ends here
        flags2 = container.read_stream(fn)["flags2"]
        fdigest = sha256_of(fn)
    fbad = int(((fplanes != planes) & valid[None]).sum())
    if fbad:
        raise AssertionError(f"fused profile: decoded symbol plane differs "
                             f"in {fbad} symbols")
    if flags2 != container.FLAG2_TORCH | container.FLAG2_TORCH_FUSED:
        raise AssertionError(f"fused stream has flags2 {flags2}")
    if flaunches != want or stray:
        raise AssertionError(f"fused kernel launched {flaunches} times on "
                             f"the fused path, expected {want}; window "
                             f"kernel {stray}, expected 0")
    frec = frec.float().cpu().numpy()
    if not np.array_equal(frec, rec):
        raise AssertionError("the fused profile's reconstruction differs "
                             "from the window profile's on the same latents")
    emit("fused_codec", t_codec, window_mode=fcodec.window_mode,
         encode_s=round(f_enc, 3), decode_s=round(f_dec, 3), bytes=fsize,
         sha256=fdigest,
         bpp=fsize * 8 / (H * W), psnr_db=psnr, flags2=flags2,
         symbol_mismatches=fbad, fused_launches=flaunches,
         window_launches=stray)

    rec_planes = (planes, valid, rec)
    dense_phase(model, geom, x, rec_planes, wk, fk, container)
    incr_phase(model, geom, x, rec_planes, wk, fk, container)
    cli_phase(x)

    k432 = shapes[3 * cfg.ngroup * 3]
    entry = {
        "name": "window_kernel", "route": "cuda",
        "source": "pseudocylindrical_convolution_torch/csrc/window.cu",
        "replaces": "pseudocylindrical_convolution_tpu/codec/"
                    "pallas_window.py:77",
        "launches": launches, "max_abs_err": max(
            s["max_abs_err"] for s in shapes.values()),
        "ms": k432["ms"], "plain_ms": k432["plain_ms"],
        "bound_ms": k432["bound_ms"], "bound_by": "bytes",
        "library_ms": k432["library_ms"],
        "library_is": k432["library_is"],
        "per_width": {str(k): {kk: v[kk] for kk in (
            "ms", "wrapper_device_ms", "wrapper_call_ms",
            "launches_per_call", "plain_ms", "bound_ms", "library_ms",
            "bytes")} for k, v in shapes.items()}}
    f432 = fshapes[3 * cfg.ngroup * 3]
    fentry = {
        "name": "fused_kernel", "route": "cuda",
        "source": "pseudocylindrical_convolution_torch/csrc/fused.cu",
        "replaces": "pseudocylindrical_convolution_tpu/codec/"
                    "pallas_fused.py:55",
        "launches": flaunches, "max_abs_err": max(
            s["max_abs_err"] for s in fshapes.values()),
        "ms": f432["ms"], "plain_ms": f432["plain_ms"],
        "bound_ms": f432["bound_ms"], "bound_by": f432["bound_by"],
        "library_ms": f432["library_ms"],
        "library_is": f432["library_is"],
        "per_width": {f"CI={v['CI']}": {kk: v[kk] for kk in (
            "ms", "wrapper_device_ms", "wrapper_call_ms",
            "launches_per_call", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "bytes", "flops")} for v in fshapes.values()}}
    if "--profile" in sys.argv[1:]:
        profile_phase(codec, planes, t_enc, "window_kernel", 12 * nsteps)
        profile_phase(fcodec, planes, f_enc, "fused_kernel", 12 * nsteps)

    # training: the codec's objects go first, so the card is free for it
    del model, codec, fcodec, rec, rec_planes, frec
    gc.collect()
    torch.cuda.empty_cache()
    train_parity_phase()
    with tempfile.TemporaryDirectory() as tmp:
        save = train_phase(tmp)
        gc.collect()
        torch.cuda.empty_cache()
        train_resume_phase()
        train_codec_phase(save, wk)
    print(json.dumps({"kernels": [entry, fentry]}), flush=True)
    print(smi, flush=True)
    print(f"wall {time.time() - T_START:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(train_resume_child() if RESUME_CHILD in sys.argv[1:]
             else main())
