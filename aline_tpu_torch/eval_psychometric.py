"""Headless psychometric evaluation on the card (the port of
``scripts/eval_psychometric.py``).

Evaluates a trained psychometric-task run under each predefined target
mask ({threshold + slope}, {guess + lapse}, all): the greedy policy's
targeted log-likelihood and RMSE curves over the acquisition steps,
printed per seed and mask and saved to
``<run_dir>/eval/psychometric_curves.npz`` with the script's keys.  Each
seed draws one batch of subjects from ``torch.Generator(seed)`` on the
device, the same one ``eval_psi`` draws, so the two pair per subject.
The model computes in the run's ``dtype`` (bfloat16 for
checkpoints/psych_100k).

Usage:
    python -m aline_tpu_torch.eval_psychometric RUN_DIR [--params NPZ]
        [--device cuda] [--batch-size 100] [--T 30] [--n-query 300]
        [--seed 0 | --seeds 0,1,2]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from aline_tpu_torch.eval.al_curves import al_rollout_curves
from aline_tpu_torch.models.aline import compute_dtype
from aline_tpu_torch.ops.target_mask import target_weight_vectors
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.utils.serialization import load_model, weights_path

PARAM_NAMES = ("alpha", "beta", "gamma", "lambda")
MASKS = {
    "threshold_slope": np.array([True, True, False, False]),
    "guess_lapse": np.array([False, False, True, True]),
    "all": np.ones(4, bool),
}


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
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--T", type=int, default=30)
    ap.add_argument("--n-query", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", default=None,
                    help="comma-separated eval seeds for across-seed error "
                         "bars (overrides --seed)")
    return ap.parse_args(argv)


def subject_batch(task, seed: int, batch_size: int, n_query: int, device):
    """The batch of subjects of one eval seed (shared with eval_psi)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return task.sample_batch(gen, batch_size, n_query=n_query)


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

    results, finals = {}, {}
    for seed in seeds:
        batch = subject_batch(task, seed, args.batch_size, args.n_query,
                              device)
        pre = "" if seed == seeds[0] else f"seed{seed}_"
        for mask_name, mask in MASKS.items():
            w_q, _ = target_weight_vectors(mask, cfg.task.embedding_type,
                                           "predefined", 0, 4)
            out = al_rollout_curves(
                model, batch.replace(target_mask=torch.from_numpy(
                    mask).to(device)), args.T,
                target_weights=torch.from_numpy(w_q).to(device),
                time_token=cfg.time_token)
            lp = out["log_prob"].cpu().numpy()
            rm = out["rmse"].cpu().numpy()
            results[f"{pre}{mask_name}_log_prob"] = lp
            results[f"{pre}{mask_name}_rmse"] = rm
            finals.setdefault(mask_name, []).append(
                (lp[:, -1].mean(), rm[:, -1].mean()))
            sel = [n for n, m in zip(PARAM_NAMES, mask) if m]
            print(f"[seed {seed}] mask {mask_name} (targets: {sel}): "
                  f"final LL {lp[:, -1].mean():.4f} "
                  f"final RMSE {rm[:, -1].mean():.4f}")
    if len(seeds) > 1:
        print(f"== across {len(seeds)} eval seeds (mean ± std) ==")
        for mask_name, vals in finals.items():
            lls = np.array([v[0] for v in vals])
            rms = np.array([v[1] for v in vals])
            print(f"{mask_name}: final LL {lls.mean():.4f} ± "
                  f"{lls.std():.4f}, final RMSE {rms.mean():.4f} ± "
                  f"{rms.std():.4f}")

    out_dir = os.path.join(args.run_dir, "eval")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "psychometric_curves.npz")
    results["seeds"] = np.array(seeds)   # pairing metadata
    np.savez(path, **results)
    print(f"saved curves to {path}")
    return results


if __name__ == "__main__":
    main()
