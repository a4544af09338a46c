"""HPO-B test-set evaluation on the card with the benchmark's fixed BO
initializations (the port of ``scripts/eval_hpo.py``).

Every (test dataset, seed) pair starts from the benchmark's fixed
initialization rows as context; the policy, random designs and the GMM
variance ("uncertainty") then acquire T points from the real query pool.
The test set is fixed by the benchmark and the policy is greedy, so the
``aline`` rows are the JAX package's but for rounding.  Prints the final
log-prob and RMSE per strategy and seed and saves the per-step curves to
``<run_dir>/eval/<--out-name>`` with the script's keys.  The model
computes in the run's ``dtype`` (bfloat16 for every checkpoints/hpo_*).

Usage:
    python -m aline_tpu_torch.eval_hpo RUN_DIR [--params NPZ]
        [--device cuda] [--T 30] [--n-query 100] [--n-target 100]
        [--seed 0 | --seeds 0,1,2] [--meta-dataset NAME]
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
                    help="npz of the run's flax parameters; default: "
                         "utils/serialization.py weights_path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--file-name", default="aline",
                    help="the run's model name: its weights are "
                         "RUN_DIR/model/<name>.npz")
    ap.add_argument("--T", type=int, default=30)
    ap.add_argument("--n-query", type=int, default=100)
    ap.add_argument("--n-target", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", default=None,
                    help="comma-separated eval seeds for across-seed error "
                         "bars (overrides --seed); the test batch is fixed "
                         "by the benchmark, seeds vary the random designs")
    ap.add_argument("--meta-dataset", default=None,
                    help="evaluate on a DIFFERENT slice than the one the "
                         "policy was trained on (must share dim_x), e.g. "
                         "the dataset-shift OOD slice 'ranger_shift'")
    ap.add_argument("--out-name", default="hpo_test_curves.npz")
    return ap.parse_args(argv)


def fixed_test_batch(task, n_query: int, n_target: int, device):
    """The benchmark's fixed test batch of ``task``'s meta-dataset."""
    splits = task.hpob.sample_test_set(
        n_context=task.n_context_init, n_query=n_query, n_target=n_target)
    return task.pack_splits(*splits, device=device)


def main(argv=None):
    args = parse_args(argv)
    cfg, model = load_model(
        args.run_dir, weights_path(args.run_dir, args.file_name, args.params),
        args.device)
    device = next(model.parameters()).device
    print(f"computing in {compute_dtype(cfg)} (the run's dtype="
          f"{cfg.dtype}) on {device}")
    if args.meta_dataset:
        print(f"OOD eval: policy trained on {cfg.task.meta_dataset!r}, "
              f"testing on {args.meta_dataset!r}")
        cfg.task.meta_dataset = args.meta_dataset
    task = build_task(cfg.task)
    batch = fixed_test_batch(task, args.n_query, args.n_target, device)
    print(f"test set: {batch.batch_size} (dataset, seed) pairs, "
          f"{task.n_context_init} fixed init rows, "
          f"{batch.n_points - task.n_context_init} query rows")

    seeds = ([int(s) for s in args.seeds.split(",")] if args.seeds
             else [args.seed])
    results, finals = {}, {}
    for seed in seeds:
        curves = compare_strategies(
            model, batch, args.T,
            torch.Generator(device=device).manual_seed(seed),
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
                  f"{lp[:, -1].mean():.4f}, "
                  f"final rmse {rm[:, -1].mean():.4f}")
    if len(seeds) > 1:
        print(f"== across {len(seeds)} eval seeds (mean ± std) ==")
        for name, vals in finals.items():
            lls = np.array([v[0] for v in vals])
            rms = np.array([v[1] for v in vals])
            print(f"{name}: final LL {lls.mean():.4f} ± {lls.std():.4f}, "
                  f"final RMSE {rms.mean():.4f} ± {rms.std():.4f}")

    out_dir = os.path.join(args.run_dir, "eval")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, args.out_name)
    results["seeds"] = np.array(seeds)   # pairing metadata
    np.savez(out_path, **results)
    print("saved", out_path)
    return results


if __name__ == "__main__":
    main()
