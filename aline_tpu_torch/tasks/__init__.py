"""Simulators.  Only the GP task is ported so far."""
from aline_tpu_torch.tasks.base import (  # noqa: F401
    Batch, batch_from_numpy, init_ctx_idx, select_design)
from aline_tpu_torch.tasks.gp import GPTask


def build_task(cfg):
    if cfg.target != "gp":
        raise NotImplementedError(
            f"task {cfg.target!r} is not ported yet (only 'gp')")
    return GPTask(cfg)
