#!/usr/bin/env python
"""Where a benchmark cell's time goes, by the program's own spans.

Runs one cell of the port's benchmark (``portbench``) on the card with the
tracer of ``aline_tpu_torch/utils/metrics.py`` switched on, and prints one
JSON line:

* ``rate``: the cell's end-to-end metric over the window, with the spans
  on (against ``python3 -m portbench.run ... --trace 0`` at the same seed,
  the cost of tracing);
* ``window``: each span name's count, host seconds and stream seconds
  (its CUDA events) over the window's spans, and the shares and medians
  that the spans give: the train step's parts over ``train.epoch``, the
  model's share of ``al.rollout`` and of ``bed.traces``, the median
  ``eig.chunk``;
* ``slice``: the benchmark's profiled units after the window, read as
  ``portbench/trace.py`` ``summarise`` reads them but with the program's
  annotations (``aline/<span>`` on the host and on the device) left out,
  and, by span: ``idle_spans`` (the idle time between device intervals,
  summed by the innermost span open on the host at each gap's midpoint),
  ``idle_in`` (the share of the idle time whose gap midpoint lies inside
  a span of each name) and ``ops_per_span`` (device operations whose
  launching runtime call lies inside a span of each name, per span);
* ``per_layer``: the cell's per-layer metrics of ``BENCHMARK.json``, read
  by the benchmark's readers from this run.

The benchmark's files are used as they are; the slice is profiled by this
script's own copy of ``portbench.trace.traced``, which also marks where
the window's spans end.

Usage:
    python scripts/span_account.py --workload al1d_200k.train_b200 \\
        --seed 5 --seconds 30 [--out spans.json]
"""
import argparse
import bisect
import contextlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PREFIX = "aline/"
OUTSIDE = "outside any span"
# shares of a parent span's stream time: (metric, child, parent)
SHARES = [("rollout.share.train", "train.rollout", "train.epoch"),
          ("loss.share.train", "train.loss", "train.epoch"),
          ("backward.share.train", "train.backward", "train.epoch"),
          ("optimizer.share.train", "train.optimizer", "train.epoch"),
          ("sample.share.train", "train.sample", "train.epoch"),
          ("forward.share.al", "model.forward", "al.rollout"),
          ("forward.share.bed", "model.forward", "bed.traces"),
          ("chunks.share.bed", "eig.chunk", "eig.fold")]


def window_account(spans) -> dict:
    """Per span name: count, host seconds, stream seconds; the SHARES
    found, and the median ``eig.chunk`` in ms."""
    names = {}
    for s in spans:
        n = names.setdefault(s.name, {"n": 0, "host_s": 0.0,
                                      "stream_s": 0.0})
        n["n"] += 1
        n["host_s"] += (s.end_ns - s.start_ns) / 1e9
        n["stream_s"] += s.stream_s() or 0.0
    out = {"spans": names}
    for metric, child, parent in SHARES:
        if child in names and names.get(parent, {}).get("stream_s"):
            out[metric] = (100.0 * names[child]["stream_s"]
                           / names[parent]["stream_s"])
    chunks = [s.stream_s() for s in spans if s.name == "eig.chunk"]
    if chunks and None not in chunks:
        out["eig_chunk_ms"] = 1e3 * statistics.median(chunks)
    return out


class Events:
    """A profile's events less the program's annotations, in the form
    ``portbench.trace.summarise`` reads."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _inside(ranges, t: float) -> bool:
    """Whether ``t`` lies in one of the sorted disjoint ``ranges``."""
    i = bisect.bisect_right(ranges, [t, float("inf")]) - 1
    return i >= 0 and ranges[i][0] <= t < ranges[i][1]


def slice_account(events, window_s: float) -> dict:
    """``summarise`` of the events without the program's annotations, and
    the idle time and the device operations by span."""
    import torch

    from portbench.trace import LOOKBACK, merged, summarise
    cuda = torch.autograd.DeviceType.CUDA
    ours = [e for e in events if e.name.startswith(PREFIX)]
    rest = [e for e in events if not e.name.startswith(PREFIX)]
    out = summarise(Events(rest), window_s)
    ranges = sorted((e.time_range.start, e.time_range.end,
                     e.name[len(PREFIX):]) for e in ours
                    if e.device_type != cuda)
    dev = [e for e in rest if e.device_type == cuda]
    iv = merged([(e.time_range.start, e.time_range.end) for e in dev])
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(iv, iv[1:])]
    idle_total = sum(g1 - g0 for g0, g1 in gaps) or float("nan")
    by_name = {}
    for s, e, n in ranges:
        by_name.setdefault(n, []).append((s, e))
    spans = {n: merged(v) for n, v in by_name.items()}
    starts = [r[0] for r in ranges]
    idle_spans, idle_in = {}, {n: 0.0 for n in spans}
    for g0, g1 in gaps:
        t = 0.5 * (g0 + g1)
        best, best_len = OUTSIDE, float("inf")
        i = bisect.bisect_right(starts, t)
        for s, e, n in ranges[max(0, i - LOOKBACK):i]:
            if t < e and e - s < best_len:
                best, best_len = n, e - s
        idle_spans[best] = idle_spans.get(best, 0.0) + (g1 - g0) / 1e6
        for n, r in spans.items():
            if _inside(r, t):
                idle_in[n] += g1 - g0
    # a device operation belongs to the span open where its runtime call
    # (the host event of the same correlation id) began
    launch = {e.id: e.time_range.start for e in rest
              if e.device_type != cuda and e.id and e.name.startswith("cu")}
    ops = {n: 0 for n in spans}
    unmatched = 0
    for e in dev:
        t = launch.get(e.id)
        if t is None:
            unmatched += 1
            continue
        for n, r in spans.items():
            if _inside(r, t):
                ops[n] += 1
    out["breakdown"]["idle_spans"] = [[k, v] for k, v in sorted(
        idle_spans.items(), key=lambda kv: -kv[1])]
    out["idle_in"] = {n: 100.0 * v / idle_total for n, v in idle_in.items()}
    out["ops_per_span"] = {n: ops[n] / len(by_name[n]) for n in spans}
    out["ops_unmatched"] = unmatched
    out["span_counts"] = {n: len(v) for n, v in by_name.items()}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None, help="also write the line here")
    args = ap.parse_args()

    import torch

    import portbench.trace
    from aline_tpu_torch.utils import metrics
    from portbench import program
    from portbench.harness import (find_cell, load_benchmark, load_config,
                                   load_kind, load_reader, load_traffic)
    from portbench.run import Context, process_start
    if not torch.cuda.is_available():
        sys.exit("span_account: needs a CUDA device")
    t_start = process_start()
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    config, traffic = load_config(cell["config"]), load_traffic(
        cell["traffic"])
    found = {}

    class Window(Context):
        def open_window(self):
            super().open_window()
            metrics.collect()                 # the set-up's spans

    @contextlib.contextmanager
    def traced(out: dict):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        found["window"] = metrics.collect()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        found["slice"] = slice_account(prof.events(), window)
        out.update({k: v for k, v in found["slice"].items()
                    if k in ("busy_s", "window_s", "n_device", "by_name",
                             "breakdown")})

    portbench.trace.traced = traced         # before the kind is loaded
    kind = load_kind(traffic["kind"])
    ctx = Window(cell, config, traffic, args.seed, args.seconds, True,
                 program.device("cuda"), t_start)
    metrics.set_tracing(True)
    res = kind.run(ctx)
    metrics.set_tracing(False)
    per_layer = {}
    for m in bench["per_layer"]:
        if args.workload in m.get("workloads", [args.workload]):
            per_layer[m["name"]] = load_reader(m["name"]).read(ctx.run)
    sl = found["slice"]
    line = {"workload": args.workload, "seed": args.seed,
            "device": torch.cuda.get_device_name(0),
            "rate": res["end_to_end"], "units": ctx.run.units,
            "window_s": ctx.run.window_s,
            "window": window_account(found["window"]),
            "slice": {k: sl[k] for k in ("busy_s", "window_s", "n_device",
                                         "idle_in", "ops_per_span",
                                         "ops_unmatched", "span_counts")},
            "breakdown": sl["breakdown"], "per_layer": per_layer}
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
