"""Config and model loading (``aline_tpu/utils/serialization.py``).

The parameters of a trained run come from a numpy ``.npz`` of its flax
parameter tree: keys are the ``/``-joined flax paths, e.g.
``params/encoder/layer_0/norm1/scale``.  ``scripts/export_params_npz.py``
writes one from a run of the JAX package; ``save_params_npz`` writes one
from a port model, so both packages' runs load the same way.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from aline_tpu_torch.config import Config, load_config
from aline_tpu_torch.models.aline import Aline, build_model
from aline_tpu_torch.utils.device import resolve_device

# The flagship GP-AL-1D run's parameters (checkpoints/al1d_200k).
AL1D_200K_PARAMS = (Path(__file__).resolve().parents[1] / "assets"
                    / "al1d_200k_params.npz")
# The location-finding BED run's parameters (checkpoints/loc_100k).
LOC_100K_PARAMS = (Path(__file__).resolve().parents[1] / "assets"
                   / "loc_100k_params.npz")
# ... and a copy of its config.json, which names the run those belong to.
LOC_100K_CONFIG = (Path(__file__).resolve().parents[1] / "assets"
                   / "loc_100k_config.json")


def _torch_key(flax_key: str) -> Tuple[str, bool]:
    """(state_dict key, whether the array is a Dense kernel to transpose)."""
    parts = flax_key.split("/")
    if parts[0] != "params":
        raise KeyError(f"{flax_key!r} is not under 'params/'")
    parts = parts[1:]
    leaf = parts[-1]
    if leaf == "kernel":        # Dense [in, out] → Linear weight [out, in]
        return ".".join(parts[:-1] + ["weight"]), True
    if leaf == "scale":         # LayerNorm scale → weight
        return ".".join(parts[:-1] + ["weight"]), False
    return ".".join(parts), False


def convert_flax_params(flat: Mapping[str, np.ndarray],
                        model: nn.Module) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model`` from ``/``-joined flax parameters.

    The GMM head's stacked ``heads_w1/b1/w2/b2`` keep their [C, ...]
    layout.  Raises KeyError on a missing or extra key and ValueError on a
    shape that does not fit.
    """
    want = model.state_dict()
    out = {}
    for key, value in flat.items():
        tkey, transpose = _torch_key(key)
        a = np.array(value, np.float32)     # a writable copy of our own
        out[tkey] = torch.from_numpy(np.ascontiguousarray(
            a.T if transpose else a))
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise KeyError(f"flax parameters do not fit the model: missing "
                       f"{missing}, extra {extra}")
    for k, t in out.items():
        if t.shape != want[k].shape:
            raise ValueError(f"{k}: shape {tuple(t.shape)}, model expects "
                             f"{tuple(want[k].shape)}")
    return out


def export_flax_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of :func:`convert_flax_params`: ``{flax key: float32
    array}`` of ``model``'s parameters (Linear weights transposed back to
    Dense kernels, LayerNorm weights renamed to scales)."""
    kinds = {name: type(m) for name, m in model.named_modules()}
    out = {}
    for key, t in model.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        a = t.detach().cpu().float().numpy()
        kind = kinds.get(owner, type(None))
        if leaf == "weight" and issubclass(kind, nn.Linear):
            leaf, a = "kernel", a.T
        elif leaf == "weight" and issubclass(kind, nn.LayerNorm):
            leaf = "scale"
        parts = ["params"] + (owner.split(".") if owner else []) + [leaf]
        out["/".join(parts)] = np.ascontiguousarray(a)
    return out


def save_params_npz(path: str, model: nn.Module) -> str:
    """Write ``model``'s parameters as an npz of the flax layout
    (readable by :func:`load_model` and ``eval_al --params``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **export_flax_params(model))
    return path


def load_model(run_dir: str, params_npz, device="cuda"
               ) -> Tuple[Config, Aline]:
    """(config, model in eval mode) of a run directory, with the
    parameters of ``params_npz``, on ``device``.  The model computes in the
    run's ``dtype`` (bfloat16 for every committed checkpoint; a copy of the
    run's config.json with ``"dtype": "float32"`` gives float32); the
    parameters are float32 either way."""
    dev = resolve_device(device)
    cfg = load_config(run_dir)
    model = build_model(cfg, dev)
    with np.load(params_npz) as flat:
        state = convert_flax_params(dict(flat), model)
    model.load_state_dict(state)
    return cfg, model.eval()
