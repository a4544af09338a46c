"""Reading a ``torch.profiler`` trace of the card."""
from __future__ import annotations


def busy_us(events) -> float:
    """Length of the union of the events' [start, end) device intervals,
    in µs: the time the card was busy."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total
