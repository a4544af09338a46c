"""Per-phase timers, scalar metric aggregation and an optional profiler
trace (``aline_tpu/utils/metrics.py``).

The trainer times its "sample" and "step" phases with ``PhaseTimer`` and
keeps the metrics of its ``verbose`` sync points in ``Metrics``.
"""
from __future__ import annotations

import collections
import contextlib
import math
import os
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Wall-clock accumulator keyed by phase name.

    Work is queued on the card asynchronously: ``phase(name, sync=True)``
    waits for the card (``torch.cuda.synchronize``) before it stops the
    clock, so the phase's time includes its device work.
    """

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)
        self._sq: Dict[str, float] = collections.defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and self.device is not None \
                    and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self._totals[name] += dt
            self._sq[name] += dt * dt
            self._counts[name] += 1

    def mean(self, name: str) -> float:
        c = self._counts[name]
        return self._totals[name] / c if c else 0.0

    def std(self, name: str) -> float:
        c = self._counts[name]
        if c < 2:
            return 0.0
        m = self.mean(name)
        return math.sqrt(max(self._sq[name] / c - m * m, 0.0))

    def total(self, name: str) -> float:
        return self._totals[name]

    def count(self, name: str) -> int:
        return self._counts[name]

    def summary(self) -> str:
        lines = []
        for name in sorted(self._totals):
            lines.append(
                f"{name}: total {self._totals[name]:.2f}s, "
                f"mean {self.mean(name)*1e3:.2f}ms ± {self.std(name)*1e3:.2f}ms "
                f"over {self._counts[name]} calls")
        return "\n".join(lines)


class Metrics:
    """Simple scalar metric store with last-value and running-mean access."""

    def __init__(self):
        self._last: Dict[str, float] = {}
        self._sums: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)

    def log(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            v = float(v)
            self._last[k] = v
            self._sums[k] += v
            self._counts[k] += 1

    def last(self, name: str) -> float:
        return self._last[name]

    def mean(self, name: str) -> float:
        c = self._counts[name]
        return self._sums[name] / c if c else 0.0


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str], name: str = "trace",
                   device: Optional[torch.device] = None):
    """A ``torch.profiler`` trace of the block, CPU activity and, on a
    CUDA ``device``, the card's, written as the Chrome trace
    ``log_dir/<name>.json`` when the block ends; no-op when ``log_dir`` is
    None.  Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))
