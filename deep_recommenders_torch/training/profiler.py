"""Profiling helpers.

Counterpart of ``deep_recommenders_tpu/training/profiler.py``:

- ``trace``: a context manager around ``torch.profiler.profile`` (CPU and,
  where there is a card, CUDA activities) that writes a Chrome trace file
  under ``logdir``, viewable in Perfetto or ``chrome://tracing``;
- ``StepTimer``: cheap wall-clock per-step timing with examples/sec.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Trace the enclosed work and write it to
    ``logdir/<pid>.<ms since the epoch>.pt.trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    name = f"{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


class StepTimer:
    def __init__(self, examples_per_step: int, log_every: int = 100):
        self.examples_per_step = examples_per_step
        self.log_every = log_every
        self._t0: Optional[float] = None
        self._steps = 0

    def step(self) -> Optional[float]:
        """Call once per step; returns examples/sec at log boundaries."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._steps += 1
        if self._steps % self.log_every == 0:
            elapsed = time.perf_counter() - self._t0
            return self._steps * self.examples_per_step / elapsed
        return None
