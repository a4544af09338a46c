"""The port's one tracer, per-phase timers, scalar metric aggregation and
an optional profiler trace (``aline_tpu/utils/metrics.py``).

**Spans.** ``span(name)`` marks a block of the program at a layer
boundary (``train.step``, ``model.forward``, ``eig.chunk``, ...).
Tracing is off unless ``set_tracing(True)``; off, a span is one flag
check and a shared null context.  On, a span records its name, the span
it opened under, its host start and end (``time.perf_counter_ns``) and a
pair of CUDA events on the current stream (where there is a card), and
enters ``torch.profiler.record_function("aline/<name>")``, so that under
a profiler it lands in the trace beside the device operations.  A span
never synchronises; ``collect()`` hands over the spans closed so far,
with their stream times read, after waiting for the device.  While a
CUDA graph is being captured, spans do nothing.

**Counters.** ``count(name, n)`` adds the host integer ``n`` to
``counts[name]`` of the innermost open span (``eig.terms``: the
contrastive terms a chunk folds; ``flash.plan``, ``flash.fwd``,
``flash.bwd``: the flash-attention launches), on another thread the
span a span begun there would take as parent.  Off, it is the same flag
check as a span; it never reads a device value.  While a CUDA graph is
captured the counts go to ``recorded_counts``' record, which each
replay adds.

**Phases.** The trainer times its "sample" and "step" phases with
``PhaseTimer``, whose totals are host time: the time to queue a phase's
work, not to run it, unless ``sync=True``.  Each phase is also the span
``<span_prefix><name>``, whose stream time ``stream_summary`` gives when
tracing is on.  The trainer keeps the metrics of its ``verbose`` sync
points in ``Metrics``.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import math
import os
import threading
import time
from typing import Dict, List, Optional

import torch

# -- spans ---------------------------------------------------------------

_on = False                  # the switch: set_tracing
_events = False              # record CUDA events (tracing on, a card)
_NULL = contextlib.nullcontext()
_ids = itertools.count()
_done: List["Span"] = []     # closed since the last collect()
_open: List["Span"] = []     # open on any thread, in the order entered
_local = threading.local()   # this thread's stack of open spans
_recording: Optional[Dict[str, int]] = None   # recorded_counts' record


def set_tracing(on: bool) -> None:
    """Turn the spans on or off for the whole process."""
    global _on, _events
    _on = bool(on)
    _events = _on and torch.cuda.is_available()


def _stack() -> List["Span"]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _innermost() -> Optional["Span"]:
    """The innermost span open on this thread or, where none is, the span
    entered last that is still open on another thread."""
    stack = _stack()
    return stack[-1] if stack else (_open[-1] if _open else None)


class Span:
    """One traced block: ``name``, ``id``, ``parent`` (the ``id`` of the
    innermost span open where it began, or None), host ``start_ns`` and
    ``end_ns`` (``time.perf_counter_ns``), ``counts`` (``count``'s
    sums inside it, not its children's), and ``stream_s()``.

    A span begun on a thread with no span open takes as parent the span
    entered last that is still open on another thread: autograd's device
    thread runs the recomputed steps of a backward pass, whose spans so
    belong to the span open where ``backward`` was called."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "counts",
                 "_ev", "_stream", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.id = next(_ids)
        self.parent = None
        self.start_ns = self.end_ns = 0
        self.counts = {}
        self._ev = None
        self._stream = None
        self._rf = None

    def __enter__(self) -> "Span":
        up = _innermost()
        self.parent = None if up is None else up.id
        self._rf = torch.profiler.record_function("aline/" + self.name)
        self._rf.__enter__()
        if _events:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
        _stack().append(self)
        _open.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._ev is not None:
            self._ev[1].record()
        _stack().pop()
        _open.remove(self)
        self._rf.__exit__(*exc)
        self._rf = None
        _done.append(self)
        return False

    def stream_s(self) -> Optional[float]:
        """Seconds between the span's two CUDA events (None without a
        card); the device must have passed the second."""
        if self._ev is not None:
            self._stream = self._ev[0].elapsed_time(self._ev[1]) / 1e3
            self._ev = None
        return self._stream


def span(name: str):
    """A context manager that traces the block as the span ``name``."""
    if not _on:
        return _NULL
    if _events and torch.cuda.is_current_stream_capturing():
        return _NULL
    return Span(name)


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to ``counts[name]`` of the span that a
    span begun here would take as parent: a kernel that autograd's
    device thread launches in a backward pass is counted in the span
    open where ``backward`` was called (nothing where no span is open
    at all).  Inside ``recorded_counts`` it adds to that block's record
    instead, whether tracing is on or off."""
    if _recording is not None:
        _recording[name] = _recording.get(name, 0) + n
        return
    if not _on:
        return
    up = _innermost()
    if up is not None:
        up.counts[name] = up.counts.get(name, 0) + n


@contextlib.contextmanager
def recorded_counts():
    """Record the block's ``count`` calls, on any thread, in the yielded
    dict {name: sum} and in no span: what a CUDA graph's capture counts,
    for each replay to add (``utils/graphs.py``)."""
    global _recording
    outer, _recording = _recording, {}
    try:
        yield _recording
    finally:
        _recording = outer


def collect() -> List[Span]:
    """The spans closed since the last call, in the order they closed,
    each with its stream time read (this waits for the device)."""
    global _done
    done, _done = _done, []
    if any(s._ev is not None for s in done):
        torch.cuda.synchronize()
    for s in done:
        s.stream_s()
    return done


class PhaseTimer:
    """Wall-clock accumulator keyed by phase name.

    Work is queued on the card asynchronously, so a phase's total is the
    host's time to queue it; ``phase(name, sync=True)`` waits for the
    card (``torch.cuda.synchronize``) before it stops the clock, so that
    the phase's time includes its device work.  Each phase is the span
    ``span_prefix + name``; with tracing on, ``stream_summary`` gives the
    phases' time on the stream.
    """

    def __init__(self, device: Optional[torch.device] = None,
                 span_prefix: str = ""):
        self.device = torch.device(device) if device is not None else None
        self.span_prefix = span_prefix
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)
        self._sq: Dict[str, float] = collections.defaultdict(float)
        self._spans: Dict[str, List[Span]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        sp = span(self.span_prefix + name)
        t0 = time.perf_counter()
        try:
            with sp:
                yield
        finally:
            if sync and self.device is not None \
                    and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self._totals[name] += dt
            self._sq[name] += dt * dt
            self._counts[name] += 1
            if sp is not _NULL and sp._ev is not None:
                self._spans[name].append(sp)

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

    def stream_summary(self) -> str:
        """The phases' stream time, as ``summary`` gives their host time:
        one line a phase traced with a card (empty otherwise).  Read once
        the device has finished them."""
        lines = []
        for name in sorted(self._spans):
            ts = [s.stream_s() for s in self._spans[name]]
            lines.append(
                f"{name}: stream {sum(ts):.2f}s, mean "
                f"{sum(ts) / len(ts) * 1e3:.2f}ms over {len(ts)} calls")
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
