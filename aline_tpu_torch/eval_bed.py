"""Headless BED evaluation on the card (the port of
``scripts/eval_bed.py``).

Loads a trained run's config and its parameters (``weights_path`` of
``utils/serialization.py``: ``--params``, the run's own npz, or the
committed npz of a banked run), rolls
the policy out greedily on fresh batches and computes the per-step sPCE and
sNMC bounds (``eval/eig.py``), optionally beside random designs at the
same protocol, and saves them to
``<run_dir>/eval/{bed,random}_bounds_N<n_query>_T<T>_L<L>.npz`` with
``scripts/eval_bed.py``'s keys.  The model computes in the run's
``dtype`` (bfloat16 for checkpoints/loc_100k and ces_200k); the bounds
in float32.

Usage:
    python -m aline_tpu_torch.eval_bed RUN_DIR [--file-name NAME]
        [--params NPZ] [--device cuda] [--L 1000000] [--M 2000] [--batch-size 200]
        [--n-query 2000] [--T 34] [--with-random-baseline]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from aline_tpu_torch.eval.eig import (
    aggregate_bounds,
    compute_eig_from_history,
    derive_seed,
    eval_boed,
)
from aline_tpu_torch.models.aline import compute_dtype
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.utils.serialization import (  # noqa: F401
    LOC_100K_CONFIG,
    LOC_100K_PARAMS,
    load_model,
    weights_path,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--params", default=None,
                    help="npz of the run's flax parameters "
                         "(scripts/export_params_npz.py); default: "
                         "utils/serialization.py weights_path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--file-name", default="aline",
                    help="the run's model name: its weights are "
                         "RUN_DIR/model/<name>.npz")
    ap.add_argument("--L", type=int, default=1_000_000)
    ap.add_argument("--M", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=200)
    ap.add_argument("--n-query", type=int, default=2000)
    ap.add_argument("--T", type=int, default=None,
                    help="rollout steps; default eval.T_final - "
                         "n_context_init")
    ap.add_argument("--L-chunk", type=int, default=32768)
    ap.add_argument("--with-random-baseline", action="store_true")
    ap.add_argument("--skip-policy", action="store_true",
                    help="only compute the random-design baseline")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def random_design_bounds(task, T: int, L: int, M: int, batch_size: int,
                         seed: int, device, L_chunk: int = 32_768):
    """Per-step bounds of random designs at the policy's protocol: M rows
    in batches of ``batch_size``, each drawing theta, T + n_context_init
    designs from the task's design prior and their outcomes, then mean
    and standard error over the M rows."""
    pces, nmcs = [], []
    for j in range((M + batch_size - 1) // batch_size):
        gen = torch.Generator(device=device).manual_seed(
            derive_seed(seed, 2, j))
        theta = task.sample_theta(gen, (batch_size,))
        x = task.unnormalise_design(
            task.sample_data(gen, batch_size, T + task.n_context_init))
        y = task.simulate(gen, x, theta[:, None])
        pce, nmc = compute_eig_from_history(
            task, theta, x, y, L, derive_seed(seed, 3, j), L_chunk=L_chunk,
            stepwise=True)
        rows = M - j * batch_size           # the last batch counts to M
        pces.append(pce[:rows].cpu().numpy())
        nmcs.append(nmc[:rows].cpu().numpy())
    return {f"random_{k}": v
            for k, v in aggregate_bounds(pces, nmcs, "se").items()}


def main(argv=None):
    args = parse_args(argv)
    cfg, model = load_model(
        args.run_dir, weights_path(args.run_dir, args.file_name, args.params),
        args.device)
    device = next(model.parameters()).device
    print(f"computing in {compute_dtype(cfg)} (the run's dtype="
          f"{cfg.dtype}) on {device}; bounds in float32")
    task = build_task(cfg.task)
    T = (args.T if args.T is not None
         else cfg.eval.T_final - cfg.task.n_context_init)

    results = {}
    if not args.skip_policy:
        bounds = eval_boed(model, task, T, args.L, args.M, args.batch_size,
                           args.seed, cfg.time_token, stepwise=True,
                           L_chunk=args.L_chunk, n_query=args.n_query)
        print("ALINE policy:")
        print("  sPCE per step:", np.array2string(bounds["pce_mean"],
                                                  precision=3))
        print("  sNMC per step:", np.array2string(bounds["nmc_mean"],
                                                  precision=3))
        results = {f"aline_{k}": v for k, v in bounds.items()}
    if args.with_random_baseline:
        results.update(random_design_bounds(
            task, T, args.L, args.M, args.batch_size, args.seed, device,
            args.L_chunk))
        print(f"random designs (M={args.M}):")
        print("  sPCE per step:",
              np.array2string(results["random_pce_mean"], precision=3))

    out_dir = os.path.join(args.run_dir, "eval")
    os.makedirs(out_dir, exist_ok=True)
    stem = "random_bounds" if args.skip_policy else "bed_bounds"
    out = os.path.join(out_dir, f"{stem}_N{args.n_query}_T{T}_L{args.L}.npz")
    np.savez(out, **results)
    print(f"saved bounds to {out}")
    return results


if __name__ == "__main__":
    main()
