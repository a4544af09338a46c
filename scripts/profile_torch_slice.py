#!/usr/bin/env python
"""Where the time of the PyTorch port's GP-AL-1D eval slice goes, on the GPU.

Runs the flagship run (checkpoints/al1d_200k, weights from the committed
npz) through ``compare_strategies`` once to warm up, then once more under
``torch.profiler`` and prints:

* the host wall time of the profiled run and the device's busy share
  (the union of kernel intervals over that wall time),
* the device time summed by kernel name, largest first,
* the device time of the GMM-head kernel and its share.

Usage:
    python scripts/profile_torch_slice.py [--batch-size 100]
        [--n-query 2000] [--T 30] [--trace chiprun_out/slice_trace.json]
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def busy_us(events):
    """Length of the union of [start, end) device intervals, in µs."""
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--n-query", type=int, default=2000)
    ap.add_argument("--T", type=int, default=30)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default=None,
                    help="also write a chrome trace here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from aline_tpu_torch.eval.al_curves import compare_strategies
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg, model = load_model(os.path.join(root, "checkpoints", "al1d_200k"),
                            AL1D_200K_PARAMS, "cuda")
    task = build_task(cfg.task)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = task.sample_batch(gen, args.batch_size, n_query=args.n_query)
    compare_strategies(model, batch, args.T, gen)          # warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compare_strategies(model, batch, args.T, gen)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    device_us = sum(t for _, t in by_name.values())
    busy = busy_us(kernels)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"B={args.batch_size} n_query={args.n_query} T={args.T}, three "
          f"strategies: wall {wall_s * 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({100 * busy / (wall_s * 1e6):.1f}% of "
          f"wall), kernel time summed {device_us / 1e3:.1f} ms")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, t) in rows[:args.top]:
        print(f"{t / 1e3:9.2f} ms {100 * t / device_us:5.1f}% "
              f"{n:6d}x  {name[:100]}")
    gmm = sum(t for name, (_, t) in by_name.items()
              if "gmm_head_fwd" in name)
    print(f"gmm_head_fwd: {gmm / 1e3:.2f} ms, {100 * gmm / device_us:.1f}% "
          f"of kernel time")
    print(json.dumps(dict(card=smi, wall_ms=wall_s * 1e3,
                          busy_ms=busy / 1e3, kernel_ms=device_us / 1e3,
                          gmm_head_fwd_ms=gmm / 1e3,
                          top=[[n, c, t / 1e3] for n, (c, t) in rows[:10]])))


if __name__ == "__main__":
    main()
