"""Checkpoint and resume (``aline_tpu/train/checkpoint.py``).

The JAX package writes an orbax tree beside a pickle of the host state;
here one ``torch.save`` file holds it all: the model's and optimizer's
``state_dict``s, the scheduler's, the device generator's state, the host
``random`` and numpy states, the epoch and the phase.  Together they make
a resumed run continue bit for bit.  Params-only snapshots (the burning
snapshot, the final model) are npz files of the flax layout
(:func:`aline_tpu_torch.utils.serialization.save_params_npz`).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save_checkpoint(path: str, state: Dict[str, Any]) -> str:
    """Write ``state`` to ``path`` atomically (a reader never sees half a
    file)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The state dict saved at ``path``, with its tensors on the CPU."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    return torch.load(path, map_location="cpu", weights_only=True)
