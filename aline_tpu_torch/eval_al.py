"""Headless active-learning evaluation on the card
(the port of ``scripts/eval_al.py``).

Loads a trained run's config and its parameters (``--params``, the run's
own npz, or the committed npz of a banked run such as checkpoints/al1d_200k:
``utils/serialization.py`` ``weights_path``), rolls out the
amortized policy and the baseline strategies on fresh GP batches, prints
the final log-prob and RMSE per strategy, and saves the per-step curves to
``<run_dir>/eval/al_curves.npz``.  The model computes in the run's
``dtype`` (bfloat16 for every committed checkpoint); to evaluate a run in
float32, point RUN_DIR at a copy of its directory whose config.json says
``"dtype": "float32"``, with ``--params`` (the copy is no banked run).

Usage:
    python -m aline_tpu_torch.eval_al RUN_DIR [--params NPZ]
        [--device cuda] [--batch-size 100] [--T 30] [--n-query 500]
        [--seed 0 | --seeds 0,1,2] [--mask default|data|theta]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from aline_tpu_torch.eval.al_curves import compare_strategies
from aline_tpu_torch.models.aline import compute_dtype
from aline_tpu_torch.tasks import build_task
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


def main(argv=None):
    args = parse_args(argv)
    if args.with_gp_baselines:
        raise NotImplementedError("--with-gp-baselines is not ported yet")
    if args.benchmark:
        raise NotImplementedError("--benchmark is not ported yet")
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

    out_dir = os.path.join(args.run_dir, "eval")
    os.makedirs(out_dir, exist_ok=True)
    stem = ("al_curves" if args.mask == "default"
            else f"al_curves_{args.mask}_mask")
    out_path = os.path.join(out_dir, f"{stem}.npz")
    results["seeds"] = np.array(seeds)
    np.savez(out_path, **results)
    print(f"saved curves to {out_path}")


if __name__ == "__main__":
    main()
