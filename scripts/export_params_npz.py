#!/usr/bin/env python
"""Export a trained run's flax parameters to a numpy ``.npz``.

The PyTorch port (``aline_tpu_torch``) cannot read orbax checkpoints; it
loads this file instead (``aline_tpu_torch.utils.serialization``).  Keys
are the ``/``-joined flax parameter paths, e.g.
``params/encoder/layer_0/self_attn/qkv_proj/kernel``; values are float32.

Usage:
    python scripts/export_params_npz.py RUN_DIR [--file-name aline_al_1d]
        [--out aline_tpu_torch/assets/al1d_200k_params.npz]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def flat_params(params) -> dict:
    """``/``-joined path → float32 numpy array for every leaf."""
    import jax
    import numpy as np

    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in leaves}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--file-name", default="aline_al_1d")
    ap.add_argument("--out", default=os.path.join(
        "aline_tpu_torch", "assets", "al1d_200k_params.npz"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from aline_tpu.utils.serialization import load_config_and_model

    _, _, params = load_config_and_model(args.run_dir, args.file_name)
    flat = flat_params(params)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {len(flat)} arrays, {n} parameters to {args.out}")


if __name__ == "__main__":
    main()
