"""Lightweight op timing (parity with extension/timer.h's time_it flag).

The port of the JAX package's ``utils/timer.py``. Work on the card runs
asynchronously, so an accurate time waits for it: ``time(name, sync=t)``
synchronises ``t``'s device before it stops the clock. For deeper profiles
use ``Timer.profile``, a ``torch.profiler`` trace."""

from __future__ import annotations

import contextlib
import time

import torch


class Timer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.records: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str, sync=None):
        """Time the block as ``name``; ``sync``, a tensor, makes the clock
        wait for the work queued on its device."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def profile(self, logdir: str):
        """Trace the block (host, and the card when there is one) into
        ``logdir`` as a TensorBoard/Chrome trace."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    logdir)):
            yield

    def summary(self) -> str:
        lines = []
        for k, v in self.records.items():
            lines.append(f"{k}: n={len(v)} mean={sum(v)/len(v)*1e3:.2f}ms")
        return "\n".join(lines)
