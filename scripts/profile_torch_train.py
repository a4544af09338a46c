#!/usr/bin/env python
"""Where the time of the PyTorch port's GP-AL-1D training step goes, on
the GPU.

Builds the training recipe (B=200, n_query_init=200, T=30, f32,
rollout_remat) from a fresh flax-equal init, starts in the main phase
(both losses, the layerwise lr), runs a few warm-up epochs, then a few
more under ``torch.profiler`` and prints:

* the time of each warm-up epoch without the profiler,
* the host wall time of the profiled epochs and the device's busy share
  (the union of kernel intervals over that wall time; the profiler slows
  the host, so this share is a lower bound),
* the device time summed by kernel name, largest first,
* the device time of the GMM-head kernels (forward and backward) and their
  share,
* the host operators with the most CPU time of their own.

Usage:
    python scripts/profile_torch_train.py [--batch-size 200] [--T 30]
        [--warmup 3] [--epochs 3] [--trace train_trace.json]
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_torch_slice import busy_us  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=200)
    ap.add_argument("--n-query", type=int, default=200)
    ap.add_argument("--T", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--out-dir", default="outputs/profile_train")
    ap.add_argument("--trace", default=None,
                    help="also write a chrome trace here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.train.loop import Trainer

    n = args.warmup + args.epochs
    cfg = parse_overrides([
        "task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
        f"task.n_query_init={args.n_query}", f"batch_size={args.batch_size}",
        f"min_T={args.T}", f"T={args.T}", "burning_epoch=0",
        f"max_epoch={n}", "checkpoint=0", "verbose=1000",
        f"output_dir={args.out_dir}"])
    trainer = Trainer(cfg, device="cuda")
    trainer._ensure_phase("main")
    warm = []
    for epoch in range(args.warmup):
        t0 = time.perf_counter()
        trainer.train_epoch(epoch)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for epoch in range(args.warmup, n):
            trainer.train_epoch(epoch)
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
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    device_us = sum(t for _, t in by_name.values())
    busy = busy_us(kernels)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    per_epoch_ms = wall_s * 1e3 / args.epochs
    print(f"card: {smi}")
    print("unprofiled epochs (ms, the first one cold): "
          + ", ".join(f"{1e3 * t:.1f}" for t in warm))
    print(f"B={args.batch_size} n_query={args.n_query} T={args.T}, main "
          f"phase, {args.epochs} epochs: wall {wall_s * 1e3:.1f} ms "
          f"({per_epoch_ms:.1f} ms/epoch, "
          f"{args.batch_size / (per_epoch_ms / 1e3):.1f} rollouts/s), "
          f"device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / (wall_s * 1e6):.1f}% of wall), kernel time "
          f"summed {device_us / 1e3:.1f} ms")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (c, t) in rows[:args.top]:
        print(f"{t / 1e3:9.2f} ms {100 * t / device_us:5.1f}% "
              f"{c:6d}x  {name[:100]}")
    gmm = {k: sum(t for name, (_, t) in by_name.items() if k in name)
           for k in ("gmm_head_fwd", "gmm_head_bwd", "sum_partials")}
    for k, t in gmm.items():
        print(f"{k}: {t / 1e3:.2f} ms, {100 * t / device_us:.1f}% of "
              f"kernel time")
    # host side: the operators whose own CPU time is largest
    cpu_ops = sorted((e for e in prof.key_averages()
                      if e.self_cpu_time_total > 0),
                     key=lambda e: -e.self_cpu_time_total)[:args.top]
    print("host: self CPU time by operator")
    for e in cpu_ops:
        print(f"{e.self_cpu_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:80]}")
    print(json.dumps(dict(card=smi, unprofiled_ms=[1e3 * t for t in warm],
                          wall_ms=wall_s * 1e3,
                          ms_per_epoch=per_epoch_ms, busy_ms=busy / 1e3,
                          kernel_ms=device_us / 1e3,
                          gmm_ms={k: t / 1e3 for k, t in gmm.items()},
                          top=[[nm, c, t / 1e3]
                               for nm, (c, t) in rows[:args.top]],
                          host_top=[[e.key, e.count,
                                     e.self_cpu_time_total / 1e3]
                                    for e in cpu_ops])))


if __name__ == "__main__":
    main()
