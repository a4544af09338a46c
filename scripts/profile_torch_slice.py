#!/usr/bin/env python
"""Where the time of the PyTorch port's GP-AL-1D eval slice goes, on the GPU.

Runs the flagship run (checkpoints/al1d_200k, weights from the committed
npz) through ``compare_strategies`` once to warm up, then once more under
``torch.profiler`` and prints:

* the host wall time of the profiled run and the device's busy share
  (the union of kernel intervals over that wall time),
* the device time summed by kernel name, largest first,
* the device time of the port's kernels (GMM head, flash attention) and
  their shares.

The model computes in the run's dtype (bfloat16: the flagship's
config.json) unless ``--dtype`` says otherwise; the dtype is printed.
``--attention-impl flash`` and ``--dtype`` run the flagship through a copy
of its run config with those changes (written under outputs/).

Usage:
    python scripts/profile_torch_slice.py [--batch-size 100]
        [--n-query 2000] [--T 30] [--attention-impl auto|flash]
        [--trace chiprun_out/slice_trace.json]
        [--dtype float32|bfloat16]
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--n-query", type=int, default=2000)
    ap.add_argument("--T", type=int, default=30)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--attention-impl", default="auto",
                    choices=("auto", "compact", "flash", "naive"))
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="compute dtype (default: the run's own)")
    ap.add_argument("--trace", default=None,
                    help="also write a chrome trace here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from aline_tpu_torch.eval.al_curves import compare_strategies
    from aline_tpu_torch.models.aline import compute_dtype
    from portbench.trace import busy_us
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run_dir = os.path.join(root, "checkpoints", "al1d_200k")
    if args.attention_impl != "auto" or args.dtype:
        with open(os.path.join(run_dir, "config.json")) as f:
            run_cfg = json.load(f)
        run_cfg["encoder"]["attention_impl"] = args.attention_impl
        run_cfg["dtype"] = args.dtype or run_cfg["dtype"]
        run_dir = os.path.join(root, "outputs", f"profile_"
                               f"{args.attention_impl}_{run_cfg['dtype']}")
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(run_cfg, f, indent=2)
    cfg, model = load_model(run_dir, AL1D_200K_PARAMS, "cuda")
    dtype = str(compute_dtype(cfg)).removeprefix("torch.")
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
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in kernels])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"B={args.batch_size} n_query={args.n_query} T={args.T}, "
          f"attention_impl={args.attention_impl}, dtype={dtype}, three "
          f"strategies: wall "
          f"{wall_s * 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({100 * busy / (wall_s * 1e6):.1f}% of "
          f"wall), kernel time summed {device_us / 1e3:.1f} ms")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, t) in rows[:args.top]:
        print(f"{t / 1e3:9.2f} ms {100 * t / device_us:5.1f}% "
              f"{n:6d}x  {name[:100]}")
    ours = {k: sum(t for name, (_, t) in by_name.items() if k in name)
            for k in ("gmm_head_fwd", "flash_plan", "flash_attn_fwd")}
    for k, t in ours.items():
        print(f"{k}: {t / 1e3:.2f} ms, {100 * t / device_us:.1f}% of "
              f"kernel time")
    print(json.dumps(dict(card=smi, attention_impl=args.attention_impl,
                          dtype=dtype, wall_ms=wall_s * 1e3,
                          busy_ms=busy / 1e3, kernel_ms=device_us / 1e3,
                          kernels_ms={k: t / 1e3 for k, t in ours.items()},
                          top=[[n, c, t / 1e3] for n, (c, t) in rows[:10]])))


if __name__ == "__main__":
    main()
