"""Tracing and per-phase timing (``dxmi_tpu.utils.profiling``,
``profiling.py:22-64``):

    with trace_if("/tmp/tb"):        # a torch.profiler trace, TensorBoard's
        run_steps()                  # format (a no-op without a directory)

    timer = PhaseTimer()
    with timer.phase("sample"): ...
    print(timer.summary())           # {'time/sample_ms_': ...}

``PhaseTimer.phase`` synchronises the card at the end of a phase when
``block_on`` is given (where the JAX package blocks on that value), so a
phase's time includes the device work queued in it.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace_if(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the CPU and, when there is one, the
    card, written for TensorBoard into ``logdir``; a no-op when None."""
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


class PhaseTimer:
    """Wall-clock per-phase accumulator."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and torch.cuda.is_available():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {f"time/{k}_ms_": 1000.0 * v / max(self.counts[k], 1)
                for k, v in self.totals.items()}

    def reset(self):
        self.totals.clear()
        self.counts.clear()
