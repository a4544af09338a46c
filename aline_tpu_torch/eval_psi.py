"""The QUEST+/PSI grid-Bayes baseline of the psychometric task on the
card (the port of ``scripts/eval_psi.py``).

Runs PSI (``eval/psi.py``) and a random-design control at the protocol,
seeds and subjects of ``eval_psychometric`` (each seed's batch from
``torch.Generator(seed)`` on the device), so that a policy's curves
(``--policy-npz``, an ``eval_psychometric`` npz of the same device and
seeds) pair per subject.  Prints the final LL and RMSE per seed, mask
and strategy and saves the curves with the script's keys to ``--out``
(default ``<run_dir>/eval/psi_curves.npz``).  The grid Bayes needs only
the run's config, not its weights.

Usage:
    python -m aline_tpu_torch.eval_psi [RUN_DIR] [--device cuda]
        [--T 30] [--batch-size 100] [--n-query 300] [--seeds 0,1,2]
        [--grid 33,17,9,7] [--policy-npz NPZ] [--out NPZ]
"""
from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np
import torch

from aline_tpu_torch.config import load_config
from aline_tpu_torch.eval.eig import derive_seed
from aline_tpu_torch.eval.psi import make_theta_grid, psi_rollout_curves
from aline_tpu_torch.eval_psychometric import MASKS, subject_batch
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir", nargs="?", default="checkpoints/psych_100k",
                    help="run dir whose config defines the task protocol")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--T", type=int, default=30)
    ap.add_argument("--n-query", type=int, default=300)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--grid", default="33,17,9,7",
                    help="grid points per theta axis "
                         "(alpha,beta,gamma,lambda)")
    ap.add_argument("--policy-npz", default=None,
                    help="eval_psychometric artifact to pair against")
    ap.add_argument("--out", default=None,
                    help="default: RUN_DIR/eval/psi_curves.npz")
    return ap.parse_args(argv)


def _policy_curves(path, seeds):
    """The policy npz's curves, refused when its seed list differs (the
    first seed's curves are unprefixed in both files)."""
    policy = dict(np.load(path))
    if "seeds" in policy:
        pol_seeds = [int(s) for s in policy.pop("seeds")]
    else:
        later = sorted({int(m.group(1)) for k in policy
                        if (m := re.match(r"seed(\d+)_", k))})
        pol_seeds = None if not later else [None] + later
    if pol_seeds is not None and (
            pol_seeds[1:] != seeds[1:] or
            (pol_seeds[0] is not None and pol_seeds[0] != seeds[0])):
        sys.exit(f"--policy-npz seed list {pol_seeds} does not match "
                 f"--seeds {seeds}; paired deltas would mispair")
    return policy


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.run_dir)
    task = build_task(cfg.task)
    seeds = [int(s) for s in args.seeds.split(",")]
    grid = make_theta_grid(task, tuple(int(n) for n in args.grid.split(",")),
                           device=device)
    policy = None
    if args.policy_npz and os.path.exists(args.policy_npz):
        policy = _policy_curves(args.policy_npz, seeds)

    results, finals = {}, {}
    for seed in seeds:
        batch = subject_batch(task, seed, args.batch_size, args.n_query,
                              device)
        pre = "" if seed == seeds[0] else f"seed{seed}_"
        for mask_name, mask in MASKS.items():
            for strat in ("psi", "random"):
                gen = torch.Generator(device=device).manual_seed(
                    derive_seed(seed, 1))
                out = psi_rollout_curves(task, batch, args.T, gen, mask=mask,
                                         strategy=strat, grid=grid)
                lp = out["log_prob"].cpu().numpy()
                rm = out["rmse"].cpu().numpy()
                results[f"{pre}{mask_name}_{strat}_log_prob"] = lp
                results[f"{pre}{mask_name}_{strat}_rmse"] = rm
                finals.setdefault((mask_name, strat), []).append(
                    (lp[:, -1], rm[:, -1]))
                line = (f"[seed {seed}] mask {mask_name} {strat}: "
                        f"final LL {lp[:, -1].mean():.4f} "
                        f"final RMSE {rm[:, -1].mean():.4f}")
                if policy is not None and strat == "psi":
                    pl = policy.get(f"{pre}{mask_name}_log_prob")
                    if pl is not None and pl.shape[0] == lp.shape[0]:
                        d = lp[:, -1] - pl[:, -1]
                        se = d.std(ddof=1) / np.sqrt(len(d))
                        line += (f" | paired dLL(psi - policy) "
                                 f"{d.mean():+.4f} ± {se:.4f}")
                print(line, flush=True)

    print(f"== across {len(seeds)} eval seeds (mean ± std of final) ==")
    for (mask_name, strat), vals in finals.items():
        lls = np.array([v[0].mean() for v in vals])
        rms = np.array([v[1].mean() for v in vals])
        print(f"{mask_name:>16s} {strat:>6s}: LL {lls.mean():.4f} ± "
              f"{lls.std():.4f}  RMSE {rms.mean():.4f} ± {rms.std():.4f}")

    out = args.out or os.path.join(args.run_dir, "eval", "psi_curves.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    results["seeds"] = np.array(seeds)   # pairing metadata
    np.savez(out, **results)
    print(f"saved curves to {out}")
    return results


if __name__ == "__main__":
    main()
