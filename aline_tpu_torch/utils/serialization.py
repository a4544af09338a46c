"""Config and model loading (``aline_tpu/utils/serialization.py``).

The parameters of a trained run come from a numpy ``.npz`` of its flax
parameter tree: keys are the ``/``-joined flax paths, e.g.
``params/encoder/layer_0/norm1/scale``.  ``scripts/export_params_npz.py``
writes one from a run of the JAX package; ``save_params_npz`` writes one
from a port model, so both packages' runs load the same way.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from aline_tpu_torch.config import Config, load_config
from aline_tpu_torch.models.aline import Aline, build_model
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.utils.device import resolve_device

ASSETS = Path(__file__).resolve().parents[1] / "assets"

# The banked runs under checkpoints/ whose parameters are committed (their
# orbax trees the port does not read): checkpoint name → (a copy of the
# run's config.json, which names the run those belong to; the npz of its
# flax parameters, written by scripts/export_params_npz.py).
BANKED_RUNS = {name: (ASSETS / f"{name}_config.json",
                      ASSETS / f"{name}_params.npz")
               for name in ("al1d_200k", "al1d_5k_demo", "loc_100k",
                            "ces_200k", "psych_100k", "hpo_glmnet_15k",
                            "hpo_ranger_15k", "hpo_rpart_15k", "hpo_rpart_45k",
                            "hpo_svm_15k", "hpo_xgboost_15k")}
# The flagship GP-AL-1D run's parameters (checkpoints/al1d_200k).
AL1D_200K_PARAMS = BANKED_RUNS["al1d_200k"][1]
# The location-finding BED run's config copy and parameters.
LOC_100K_CONFIG, LOC_100K_PARAMS = BANKED_RUNS["loc_100k"]


def weights_path(run_dir: str, file_name: str, params=None) -> str:
    """The npz of a run's weights: ``params`` when given; else
    ``<run_dir>/model/<file_name stem>.npz``, which the port's trainer
    writes; else, for a run whose config.json is a banked run's, that
    run's committed npz.  Raises FileNotFoundError for any other run."""
    if params is not None:
        return str(params)
    own = os.path.join(run_dir, "model", f"{file_name.split('.')[0]}.npz")
    if os.path.exists(own):
        return own
    with open(os.path.join(run_dir, "config.json")) as f:
        run_cfg = json.load(f)
    for config, params_npz in BANKED_RUNS.values():
        if run_cfg == json.loads(config.read_text()):
            return str(params_npz)
    raise FileNotFoundError(
        f"no weights for {run_dir}: {own} does not exist and the run is not "
        f"one of the banked runs {sorted(BANKED_RUNS)}; pass --params or "
        f"--file-name")


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
    # the HPO task sets dim_x from its data (flax takes it from the
    # batch), so the task is built before the model
    build_task(cfg.task)
    model = build_model(cfg, dev)
    with np.load(params_npz) as flat:
        state = convert_flax_params(dict(flat), model)
    model.load_state_dict(state)
    return cfg, model.eval()
