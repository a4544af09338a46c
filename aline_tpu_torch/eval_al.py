"""Headless active-learning evaluation on the card
(the port of ``scripts/eval_al.py``).

Loads a trained run's config and its parameters (``--params``, the run's
own npz, or the committed npz of a banked run such as checkpoints/al1d_200k:
``utils/serialization.py`` ``weights_path``), rolls out the
amortized policy and the baseline strategies on fresh GP batches, prints
the final log-prob and RMSE per strategy, and saves the per-step curves to
``<run_dir>/eval/al_curves.npz``.  On the first seed's batch, drawn
again, ``--with-gp-baselines`` adds the six classical GP baselines
(``eval/gp_al_baselines.py``; keys ``gp_<method>_{log_prob,rmse}``), and
``--benchmark NAME`` the three strategies on an analytic benchmark
function (``tasks/benchmarks.py``; keys ``bench_<name>_<strategy>_rmse``),
from a generator of its own seeded with ``derive_seed(seed, 1)``.
The model computes in the run's
``dtype`` (bfloat16 for every committed checkpoint); to evaluate a run in
float32, point RUN_DIR at a copy of its directory whose config.json says
``"dtype": "float32"``, with ``--params`` (the copy is no banked run).

Usage:
    python -m aline_tpu_torch.eval_al RUN_DIR [--params NPZ]
        [--device cuda] [--batch-size 100] [--T 30] [--n-query 500]
        [--seed 0 | --seeds 0,1,2] [--mask default|data|theta]
        [--with-gp-baselines [--gp-fit-steps 80]] [--benchmark NAME]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from aline_tpu_torch.config import BenchmarkTaskConfig
from aline_tpu_torch.eval.al_curves import compare_strategies
from aline_tpu_torch.eval.eig import derive_seed
from aline_tpu_torch.eval.gp_al_baselines import compare_acquisition_methods
from aline_tpu_torch.models.aline import compute_dtype
from aline_tpu_torch.tasks import BenchmarkTask, build_task
from aline_tpu_torch.utils.serialization import load_model, weights_path


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
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--T", type=int, default=30)
    ap.add_argument("--n-query", type=int, default=500)
    ap.add_argument("--with-gp-baselines", action="store_true")
    ap.add_argument("--gp-fit-steps", type=int, default=80)
    ap.add_argument("--benchmark", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", default=None,
                    help="comma-separated eval seeds (overrides --seed); "
                         "extra seeds' curves are saved with a seed{N}_ "
                         "prefix")
    ap.add_argument("--mask", default="default",
                    choices=("default", "data", "theta"),
                    help="target mask for the curves: 'data' / 'theta' "
                         "select only the data / theta targets")
    return ap.parse_args(argv)


def benchmark_batch(task_cfg, name: str, n_query: int,
                    gen: torch.Generator, batch_size: int):
    """A batch of the benchmark function ``name`` shaped as the run's
    task: its widths, initial context, targets and design box; ``mix``
    mode for a mix-embedding run (zero theta targets), ``data``
    otherwise."""
    tc = task_cfg
    task = BenchmarkTask(BenchmarkTaskConfig(
        name="Benchmark", dim_x=tc.dim_x, embedding_type=tc.embedding_type,
        n_context_init=tc.n_context_init, n_query_init=n_query,
        n_target_data=tc.n_target_data, n_target_theta=tc.n_target_theta,
        design_scale=tc.design_scale, benchmark_name=name))
    return task.sample_batch(
        gen, batch_size, mode="mix" if tc.embedding_type == "mix" else "data")


def main(argv=None):
    args = parse_args(argv)
    cfg, model = load_model(
        args.run_dir, weights_path(args.run_dir, args.file_name, args.params),
        args.device)
    device = next(model.parameters()).device
    print(f"computing in {compute_dtype(cfg)} (the run's dtype="
          f"{cfg.dtype}) on {device}")
    task = build_task(cfg.task)
    seeds = ([int(s) for s in args.seeds.split(",")] if args.seeds
             else [args.seed])

    def apply_mask(batch):
        if args.mask == "default":
            return batch
        sel = torch.arange(batch.n_target, device=device) \
            < batch.n_target_data
        return batch.replace(target_mask=sel if args.mask == "data"
                             else ~sel)

    results, finals = {}, {}
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(seed)
        batch = apply_mask(task.sample_batch(gen, args.batch_size,
                                             n_query=args.n_query))
        curves = compare_strategies(model, batch, args.T, gen,
                                    time_token=cfg.time_token)
        pre = "" if seed == seeds[0] else f"seed{seed}_"
        for name, out in curves.items():
            lp = out["log_prob"].cpu().numpy()
            rm = out["rmse"].cpu().numpy()
            results[f"{pre}{name}_log_prob"] = lp
            results[f"{pre}{name}_rmse"] = rm
            finals.setdefault(name, []).append(
                (lp[:, -1].mean(), rm[:, -1].mean()))
            print(f"[seed {seed}] {name}: final log_prob "
                  f"{lp[:, -1].mean():.4f}, final rmse "
                  f"{rm[:, -1].mean():.4f}")
    if len(seeds) > 1:
        print(f"== across {len(seeds)} eval seeds (mean ± std) ==")
        for name, vals in finals.items():
            lls = np.array([v[0] for v in vals])
            rms = np.array([v[1] for v in vals])
            print(f"{name}: final LL {lls.mean():.4f} ± {lls.std():.4f}, "
                  f"final RMSE {rms.mean():.4f} ± {rms.std():.4f}")

    # the first seed's batch drawn again, for the classical baselines; the
    # benchmark function has a stream of its own, so that neither section
    # moves the other's draws
    gen = torch.Generator(device=device).manual_seed(seeds[0])
    batch = apply_mask(task.sample_batch(gen, args.batch_size,
                                         n_query=args.n_query))
    if args.with_gp_baselines and batch.n_target_data > 0:
        gp_res = compare_acquisition_methods(
            batch.x, batch.y, batch.target_x,
            batch.target_all[:, :batch.n_target_data],
            task.n_context_init, args.T, gen, fit_steps=args.gp_fit_steps)
        for name, out in gp_res.items():
            results[f"gp_{name}_log_prob"] = out["log_prob"].cpu().numpy()
            results[f"gp_{name}_rmse"] = out["rmse"].cpu().numpy()
            print(f"gp_{name}: final rmse "
                  f"{results[f'gp_{name}_rmse'][:, -1].mean():.4f}")

    if args.benchmark:
        bgen = torch.Generator(device=device).manual_seed(
            derive_seed(seeds[0], 1))
        bbatch = benchmark_batch(cfg.task, args.benchmark, args.n_query,
                                 bgen, args.batch_size)
        bcurves = compare_strategies(model, bbatch, args.T, bgen,
                                     time_token=cfg.time_token)
        for name, out in bcurves.items():
            results[f"bench_{args.benchmark}_{name}_rmse"] = \
                out["rmse"].cpu().numpy()

    out_dir = os.path.join(args.run_dir, "eval")
    os.makedirs(out_dir, exist_ok=True)
    stem = ("al_curves" if args.mask == "default"
            else f"al_curves_{args.mask}_mask")
    out_path = os.path.join(out_dir, f"{stem}.npz")
    results["seeds"] = np.array(seeds)
    np.savez(out_path, **results)
    print(f"saved curves to {out_path}")
    return results


if __name__ == "__main__":
    main()
