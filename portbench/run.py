"""Run one cell of the port's benchmark.

    python3 -m portbench.run --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic, makes the inputs from the
seed, warms up the cell's own shapes, measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON line as the last line of standard output (the numbers compared,
each beside its limit, are also the last lines of standard error).  With
``--trace 1`` the metrics are the cell's per-layer ones, read from a
profiled slice of units after the window and from the window's spans.

A run needs as many CUDA devices as the cell asks for; it exits with
code 2, printing no result, where there are fewer.  It exits with code 3
if JAX or the JAX package was loaded into the process.
"""
from __future__ import annotations

import time

T_MODULE = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench.harness import (  # noqa: E402
    ROOT,
    Run,
    checks_from,
    find_cell,
    load_benchmark,
    load_config,
    load_kind,
    load_limits,
    load_reader,
    load_traffic,
)

FORBIDDEN = ("jax", "jaxlib", "flax", "aline_tpu")
CACHE = ROOT / ".portbench_cache"


def process_start() -> float:
    """The wall-clock time at which this process started (Linux), else
    the time this module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_MODULE


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Context:
    """What a traffic kind's runner gets: the cell's parts, the seed,
    the window's length, the run record, the device."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device,
                 t_start):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.run = Run(config, traffic)
        self.t_start = t_start
        self.t_open = None

    def open_window(self):
        self.sync()
        self.t_open = time.time()

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", bench=None, config=None, traffic=None,
            limits=None, t_start=None):
    """Run a cell; returns (result line as a dict, checks).  ``config``,
    ``traffic`` and ``limits`` replace the cell's files where given."""
    bench = bench or load_benchmark()
    cell = find_cell(bench, workload)
    config = config or load_config(cell["config"])
    traffic = traffic or load_traffic(cell["traffic"])
    limits = limits or load_limits(workload)
    kind = load_kind(traffic["kind"])
    from portbench import program
    dev = program.device(device)
    ctx = Context(cell, config, traffic, seed, seconds, trace, dev,
                  t_start or process_start())
    out = kind.run(ctx)
    checks = checks_from(out["readings"], limits)
    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            v = load_reader(m["name"]).read(ctx.run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(out["end_to_end"], setup_s=ctx.t_open - ctx.t_start)
        metrics = {}
        for m in bench["end_to_end"]:
            if workload not in m.get("workloads", [workload]):
                continue
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": out["device_kind"], "count": cell["chips"],
                "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": all(c.ok for c in checks),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev_info}
    if trace and ctx.run.trace:
        dev_info["busy_s"] = ctx.run.trace["busy_s"]
        dev_info["window_s"] = ctx.run.trace["window_s"]
        result["breakdown"] = ctx.run.trace["breakdown"]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    cell = find_cell(load_benchmark(), args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    result, checks = execute(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
