#!/usr/bin/env python
"""The JAX package's side of the bfloat16-vs-float32 gap of the flagship
eval: one GP batch, the AL curves in three computations, saved for
``scripts/bf16_gap_torch.py`` (which runs the PyTorch port on the same
batch and compares).

The flagship (checkpoints/al1d_200k, its committed params npz) rolls out
``--T`` steps of strategies ``aline`` and ``uncertainty`` on one batch
(``jax.random.key(--seed)``, ``--batch-size`` rows, ``--n-query``) in:

* ``f32``       — ``dtype=float32``, jitted;
* ``bf16_jit``  — the run's ``dtype=bfloat16``, jitted (what
  ``scripts/eval_al.py`` runs; XLA keeps excess precision inside fusions);
* ``bf16``      — ``dtype=bfloat16`` without jit: every bfloat16 rounding
  the flax modules declare happens.

Usage (CPU):
    JAX_PLATFORMS=cpu python scripts/bf16_gap_jax.py --out gap.npz
        [--batch-size 32] [--n-query 500] [--T 15] [--seed 5]
"""
import argparse
import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIELDS = ("x", "y", "ctx_mask", "target_x", "target_all", "theta",
          "target_mask", "t")
STRATEGIES = ("aline", "uncertainty")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--n-query", type=int, default=500)
    ap.add_argument("--T", type=int, default=15)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from flax.traverse_util import unflatten_dict

    from aline_tpu.eval.al_curves import al_rollout_curves
    from aline_tpu.models.aline import build_model
    from aline_tpu.tasks.gp import GPTask
    from aline_tpu.utils.serialization import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run_dir = os.path.join(root, "checkpoints", "al1d_200k")
    npz = os.path.join(root, "aline_tpu_torch", "assets",
                       "al1d_200k_params.npz")
    with np.load(npz) as f:
        params = unflatten_dict({k: jnp.asarray(f[k]) for k in f.files},
                                sep="/")
    cfg = load_config(run_dir)
    batch = GPTask(cfg.task).sample_batch(jax.random.key(args.seed),
                                          args.batch_size,
                                          n_query=args.n_query)
    out = {f"batch_{f}": np.asarray(getattr(batch, f)) for f in FIELDS}
    out["batch_ctx_capacity"] = np.asarray(batch.ctx_capacity)
    cfg32 = copy.deepcopy(cfg)      # build_model sets cfg.encoder.dtype
    cfg32.dtype = "float32"
    models = {"bf16": build_model(cfg), "f32": build_model(cfg32)}
    for run, model, jit in (("f32", models["f32"], True),
                            ("bf16_jit", models["bf16"], True),
                            ("bf16", models["bf16"], False)):
        for strategy in STRATEGIES:
            if jit:
                curves = al_rollout_curves(model, params, batch, args.T,
                                           jax.random.key(1),
                                           strategy=strategy)
            else:
                with jax.disable_jit():
                    curves = al_rollout_curves(model, params, batch, args.T,
                                               jax.random.key(1),
                                               strategy=strategy)
            for key, v in curves.items():
                out[f"jax_{run}_{strategy}_{key}"] = np.asarray(v)
            lp = out[f"jax_{run}_{strategy}_log_prob"]
            print(f"JAX {run} {strategy}: final mean log-prob "
                  f"{lp[:, -1].mean():.4f}", flush=True)
    np.savez(args.out, **out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
