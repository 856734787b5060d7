"""Stage timing and profiling (lrr_tpu/utils/timers.py).

Equivalent of the reference's wall-clock instrumentation (vul_timer
PROGRESS_OUTPUT/TIMER_OUTPUT macros, itk::TimeProbe around every extraction
stage), plus a `torch.profiler` trace context.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimers:
    """Accumulating named timers.  With `sync`, a timed stage starts and
    ends in `torch.cuda.synchronize()` once a CUDA context exists, so work
    queued on the card counts for the stage that queued it."""

    def __init__(self, sync: bool = True):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync

    def _sync(self):
        if self.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def time(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name:32s} {self.totals[name]:9.3f}s  x{self.counts[name]}"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k]}
            for k in self.totals
        }


@contextlib.contextmanager
def profile_trace(logdir: str):
    """`torch.profiler` trace context: CPU activity, and the card's where
    there is one; the Chrome trace goes to `<logdir>/trace.json`.  Yields
    the profiler (for `key_averages()`)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
