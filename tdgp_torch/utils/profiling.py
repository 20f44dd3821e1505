"""Tracing and phase timing of the loop (port of `tdgp/utils/profiling.py`).

  - trace(): a torch.profiler trace of the CPU and the card, written for
    TensorBoard under <run_dir>/profiling_logs
  - PhaseTimer: host wall time around phases, the card synchronized first
    where asked, reported as Timing/<phase> in stats.jsonl.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class PhaseTimer:
    """Accumulates per-phase wall time; the means land in stats.jsonl as
    Timing/<phase>."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[torch.device] = None):
        """Times the block; with `sync`, a CUDA device, the time runs until
        the card has finished the work enqueued in it."""
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.type == 'cuda':
            torch.cuda.synchronize(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def means(self) -> Dict[str, float]:
        return {f'Timing/{k}': self.totals[k] / self.counts[k] for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()
