"""Reading a ``torch.profiler`` trace of the card: the busy time as the
union of the device intervals, kernel counts and times by name, and the
idle gaps labelled by the host operation that was running in them."""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Tuple

import torch

TOP = 10
LOOKBACK = 400
NAME_CHARS = 160


def merged(spans: List[Tuple[float, float]]) -> List[List[float]]:
    """The union of [start, end) intervals, as disjoint sorted ones."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals, in microseconds."""
    return sum(e - s for s, e in merged(spans))


def _label(cpu_events, starts, t: float) -> str:
    """The innermost host operation running at time ``t``, among the
    ``LOOKBACK`` operations that started last before it (``cpu_events``
    sorted by start, ``starts`` their starts)."""
    best, best_len = "host outside any operator", float("inf")
    i = bisect.bisect_right(starts, t)
    for s, e, name in cpu_events[max(0, i - LOOKBACK):i]:
        if t < e and e - s < best_len:
            best, best_len = name, e - s
    return best


def summarise(prof, window_s: float) -> Dict:
    """``busy_s``, ``window_s``, ``n_device`` (device operations),
    ``by_name`` {name: (calls, seconds)}, and ``breakdown`` with the
    device operations that took most time and the idle time between
    them summed by the host operation running in each gap."""
    dev, cpu = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((s, t, e.name))
        elif not e.name.startswith("ProfilerStep"):
            cpu.append((s, t, e.name))
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    by_name: Dict[str, list] = {}
    for s, t, n in dev:
        c = by_name.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += (t - s) / 1e6
    spans = [(s, t) for s, t, _ in dev]
    iv = merged(spans)
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(iv, iv[1:])]
    cpu.sort()
    starts = [c[0] for c in cpu]
    idle: Dict[str, float] = {}
    # label only the longest gaps: most of the idle time, bounded work
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        lab = _label(cpu, starts, 0.5 * (g0 + g1))
        idle[lab] = idle.get(lab, 0.0) + (g1 - g0) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    ops = [(k[:NAME_CHARS], v) for k, v in ops]
    return dict(
        busy_s=busy_us(spans) / 1e6, window_s=window_s, n_device=len(dev),
        by_name={k: tuple(v) for k, v in by_name.items()},
        breakdown=dict(
            device_ops=[[k, v[1]] for k, v in ops],
            idle_gaps=[[k, v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]]))


@contextlib.contextmanager
def traced(out: dict):
    """Profile the card and the host over the block; on exit ``out``
    holds ``summarise`` of it, the window timed between two
    synchronisations."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    out.update(summarise(prof, window))
