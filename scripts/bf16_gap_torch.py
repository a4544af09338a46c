#!/usr/bin/env python
"""The PyTorch port's side of the bfloat16-vs-float32 gap of the flagship
eval, against the JAX package's curves that ``scripts/bf16_gap_jax.py``
saved for the same batch.

Rolls the flagship out in the port in bfloat16 (the run's dtype) and in
float32 (what the port computed before it followed the run's dtype), on
the CPU by default, then prints, for each pair of computations and each
strategy: the rows whose chosen indices differ at some step, the rows
whose first choice differs, the largest step-0 log-prob difference, and
each side's final mean log-prob and RMSE; and the same as one JSON line.

Usage:
    python scripts/bf16_gap_torch.py gap.npz [--device cpu]
"""
import argparse
import json
import os
import sys
import tempfile
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PAIRS = (("jax_bf16_jit", "jax_f32"), ("jax_bf16", "jax_f32"),
         ("jax_bf16", "jax_bf16_jit"), ("port_f32", "jax_bf16"),
         ("port_bf16", "jax_bf16"), ("port_bf16", "jax_bf16_jit"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("npz")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    import numpy as np
    import torch

    from aline_tpu_torch.eval.al_curves import al_rollout_curves
    from aline_tpu_torch.tasks.base import batch_from_numpy
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run_dir = os.path.join(root, "checkpoints", "al1d_200k")
    with np.load(args.npz) as f:
        saved = {k: f[k] for k in f.files}
    src = types.SimpleNamespace(
        **{k[len("batch_"):]: v for k, v in saved.items()
           if k.startswith("batch_")}, ctx_idx=None)
    batch = batch_from_numpy(src, args.device)
    T = saved["jax_f32_aline_idx"].shape[1]
    strategies = sorted({k.split("_")[2] for k in saved
                         if k.startswith("jax_f32_")})
    runs = {}
    with open(os.path.join(run_dir, "config.json")) as f:
        run_cfg = json.load(f)
    with tempfile.TemporaryDirectory() as f32_dir:
        with open(os.path.join(f32_dir, "config.json"), "w") as f:
            json.dump(dict(run_cfg, dtype="float32"), f)
        for name in ("f32", "bf16"):
            # float32 through a copy of the run's config; bf16 is the run's
            _, model = load_model(f32_dir if name == "f32" else run_dir,
                                  AL1D_200K_PARAMS, args.device)
            for strategy in strategies:
                c = al_rollout_curves(model, batch, T, strategy=strategy)
                for key, v in c.items():
                    runs[f"port_{name}_{strategy}_{key}"] = v.cpu().numpy()
    runs.update({k: v for k, v in saved.items() if k.startswith("jax_")})

    result = {}
    for a, b in PAIRS:
        for s in strategies:
            ia, ib = runs[f"{a}_{s}_idx"], runs[f"{b}_{s}_idx"]
            la, lb = runs[f"{a}_{s}_log_prob"], runs[f"{b}_{s}_log_prob"]
            ra, rb = runs[f"{a}_{s}_rmse"], runs[f"{b}_{s}_rmse"]
            r = dict(rows=int(ia.shape[0]),
                     rows_any_choice_differs=int((ia != ib).any(1).sum()),
                     rows_first_choice_differs=int((ia[:, 0]
                                                    != ib[:, 0]).sum()),
                     step0_max_abs=float(np.abs(la[:, 0] - lb[:, 0]).max()),
                     mean_log_prob_steps={k: [float(la[:, k].mean()),
                                              float(lb[:, k].mean())]
                                          for k in range(0, T + 1, 5)},
                     final_mean_log_prob=[float(la[:, -1].mean()),
                                          float(lb[:, -1].mean())],
                     final_mean_rmse=[float(ra[:, -1].mean()),
                                      float(rb[:, -1].mean())])
            result[f"{a} vs {b} {s}"] = r
            print(f"{a} vs {b}, {s}: {r['rows_any_choice_differs']} of "
                  f"{r['rows']} rows change a choice "
                  f"({r['rows_first_choice_differs']} the first); step 0 "
                  f"log-prob within {r['step0_max_abs']:.4f}; final mean "
                  f"log-prob {r['final_mean_log_prob'][0]:.4f} vs "
                  f"{r['final_mean_log_prob'][1]:.4f}, RMSE "
                  f"{r['final_mean_rmse'][0]:.4f} vs "
                  f"{r['final_mean_rmse'][1]:.4f}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
