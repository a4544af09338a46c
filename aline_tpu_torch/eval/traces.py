"""Greedy rollout tracer for the BED evaluation
(``aline_tpu/eval/traces.py``).

Runs the model greedily for T steps and returns (theta_0, designs,
outcomes).  The history INCLUDES the initial context points in front,
and the time token runs backwards, (T - t)/T, the eval direction of
``aline_tpu`` (training counts up).
"""
from __future__ import annotations

from typing import Tuple

import torch

from aline_tpu_torch.tasks.base import Batch, init_ctx_idx
from aline_tpu_torch.train.rollout import rollout


@torch.no_grad()
def get_traces(model, task, batch: Batch, T: int, time_token: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Roll out greedily and collect the experiment history.

    Returns:
        theta_0: [B, ...] task-natural latents of the batch.
        x:       [B, n_context_init + T, dim_x] UNNORMALISED design
                 history (initial context first, then the chosen designs).
        y:       [B, n_context_init + T, dim_y] outcome history.
    Both come from the batch's float32 tensors, whatever the model's
    compute dtype.
    """
    n_ctx = task.n_context_init
    # the compact attention reads the index buffer: its capacity must
    # cover the whole rollout, or the attended key set stops growing
    batch = init_ctx_idx(batch, min(n_ctx + T, batch.n_points))
    zero_w = torch.zeros(batch.n_target, device=batch.x.device)
    ro = rollout(model, batch, T, zero_w, zero_w, None,
                 time_token=time_token, time_forward=False, use_remat=False)
    xs = torch.cat([batch.x[:, :n_ctx], ro.xs.transpose(0, 1)], dim=1)
    ys = torch.cat([batch.y[:, :n_ctx], ro.ys.transpose(0, 1)], dim=1)
    return batch.theta, task.unnormalise_design(xs), ys
