"""The sPCE/sNMC bounds against the contrastive count L, on the card (the
port of ``scripts/eval_bed_trend.py``).

One fold at the largest L is read as it passes each of
``--L-checkpoints`` (``eval/eig.py`` ``compute_eig_from_history(
L_checkpoints=...)``), so the whole curve costs its most expensive
point.  Batch s of ``--batch-size`` rows is drawn from ``derive_seed(
seed, 0, s)``, rolled out greedily, and bounded with the contrastive seed
``derive_seed(derive_seed(seed, 1), s)``: the row at the largest L is
then ``eval_eig_from_history(..., seed=derive_seed(seed, 1),
batch_size=--batch-size)`` of the same traces, bit for bit.  Prints the
table and saves ``L<L>_pce``/``L<L>_nmc`` [M] per L (snapped up to a
multiple of the chunk) to ``<run_dir>/eval/bounds_trend_M<M>_T<T>.npz``.

Usage:
    python -m aline_tpu_torch.eval_bed_trend RUN_DIR [--params NPZ]
        [--device cuda] [--L-checkpoints 1000000,3000000,10000000,30000000]
        [--M 200] [--batch-size 100] [--n-query 2000] [--T T] [--seed 0]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from aline_tpu_torch.eval.eig import compute_eig_from_history, derive_seed
from aline_tpu_torch.eval.traces import get_traces
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.utils.serialization import load_model, weights_path


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--params", default=None,
                    help="npz of the run's flax parameters; default: "
                         "utils/serialization.py weights_path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--file-name", default="aline")
    ap.add_argument("--L-checkpoints",
                    default="1000000,3000000,10000000,30000000")
    ap.add_argument("--M", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--n-query", type=int, default=2000)
    ap.add_argument("--T", type=int, default=None)
    ap.add_argument("--L-chunk", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def bounds_trend(model, task, T: int, Ls, M: int, batch_size: int,
                 seed: int, time_token: bool = False, n_query=None,
                 L_chunk: int = 32_768):
    """({L_eff: (pce [M], nmc [M])}, (theta, x, y) of the M rows)."""
    device = next(model.parameters()).device
    per_L, traces = {}, []
    eig_seed = derive_seed(seed, 1)
    n_steps = (M + batch_size - 1) // batch_size
    for step in range(n_steps):
        gen = torch.Generator(device=device).manual_seed(
            derive_seed(seed, 0, step))
        batch = task.sample_batch(gen, batch_size, n_query=n_query)
        theta, x, y = get_traces(model, task, batch, T, time_token)
        traces.append((theta, x, y))
        curve = compute_eig_from_history(
            task, theta, x, y, max(Ls), derive_seed(eig_seed, step),
            L_chunk=L_chunk, L_checkpoints=Ls)
        for L_eff, (pce, nmc) in curve.items():
            d = per_L.setdefault(L_eff, ([], []))
            d[0].append(pce.cpu().numpy())
            d[1].append(nmc.cpu().numpy())
        print(f"outer step {step + 1}/{n_steps} done", flush=True)
    rows = {L_eff: (np.concatenate(p)[:M], np.concatenate(n)[:M])
            for L_eff, (p, n) in sorted(per_L.items())}
    return rows, tuple(torch.cat(t)[:M] for t in zip(*traces))


def main(argv=None):
    args = parse_args(argv)
    cfg, model = load_model(
        args.run_dir, weights_path(args.run_dir, args.file_name, args.params),
        args.device)
    task = build_task(cfg.task)
    T = (args.T if args.T is not None
         else cfg.eval.T_final - cfg.task.n_context_init)
    Ls = sorted(int(float(s)) for s in args.L_checkpoints.split(","))
    rows, _ = bounds_trend(model, task, T, Ls, args.M, args.batch_size,
                           args.seed, cfg.time_token, args.n_query,
                           args.L_chunk)
    results = {}
    print(f"{'L':>12} {'sPCE':>18} {'sNMC':>18} {'gap':>8}")
    for L_eff, (pce, nmc) in rows.items():
        se_p = pce.std(0) / np.sqrt(pce.shape[0])
        se_n = nmc.std(0) / np.sqrt(nmc.shape[0])
        results[f"L{L_eff}_pce"] = pce
        results[f"L{L_eff}_nmc"] = nmc
        print(f"{L_eff:>12d} {pce.mean():>10.3f} ± {se_p:<5.3f} "
              f"{nmc.mean():>10.3f} ± {se_n:<5.3f} "
              f"{nmc.mean() - pce.mean():>8.3f}", flush=True)
    out_dir = os.path.join(args.run_dir, "eval")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"bounds_trend_M{args.M}_T{T}.npz")
    np.savez(out, **results)
    print("saved", out)
    return results


if __name__ == "__main__":
    main()
