"""The benchmark's one door into the system under test, the PyTorch and
CUDA package ``aline_tpu_torch``: its model built from a configuration
file, with the configuration's weights, and its batches.  The package is
imported here, when a run starts, and nowhere in ``reference/``."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from portbench.harness import ROOT


def device(name: str) -> torch.device:
    """The program's device, with the program's backend settings (TF32
    off, float32 sums of bfloat16 products on the card)."""
    from aline_tpu_torch.utils.device import resolve_device
    return resolve_device(name)


def run_config(cfg_file: dict, **overrides):
    from aline_tpu_torch.config import config_from_dict
    d = dict(cfg_file["run"])
    d.update(overrides)
    return config_from_dict(d)


def weights(cfg_file: dict) -> dict:
    with np.load(ROOT / cfg_file["weights"]) as z:
        return {k: z[k] for k in z.files}


def model(cfg_file: dict, dev):
    """The program's model of the configuration, with its weights, in
    eval mode."""
    from aline_tpu_torch.models.aline import build_model
    from aline_tpu_torch.utils.serialization import convert_flax_params
    cfg = run_config(cfg_file)
    m = build_model(cfg, dev)
    m.load_state_dict(convert_flax_params(weights(cfg_file), m))
    return cfg, m.eval()


def batch(x, y, target_x, target_all, theta, n_ctx: int,
          target_mask=None):
    """The program's ``Batch`` of these tensors, the first ``n_ctx``
    points in the context."""
    from aline_tpu_torch.tasks.base import Batch
    B, N = x.shape[:2]
    ctx = torch.zeros(B, N, dtype=torch.bool, device=x.device)
    ctx[:, :n_ctx] = True
    if target_mask is None:
        target_mask = torch.ones(target_all.shape[1], dtype=torch.bool,
                                 device=x.device)
    return Batch(x=x, y=y, ctx_mask=ctx, target_x=target_x,
                 target_all=target_all, theta=theta, target_mask=target_mask,
                 t=torch.zeros((), device=x.device))


def arch(cfg_file: dict) -> dict:
    """The widths the reference needs, from the configuration file."""
    r = cfg_file["run"]
    return dict(num_layers=r["encoder"]["num_layers"],
                n_head=r["encoder"]["n_head"],
                std_min=r["head"]["std_min"])


def weights_path(cfg_file: dict) -> Path:
    return ROOT / cfg_file["weights"]
