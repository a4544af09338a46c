"""The CES benchmark's inputs, drawn on the device from a seed by the
task's generative model: the latents from the prior, the candidate
basket pairs uniform in [0, design_scale]^6, and the rating at every
candidate from the censored sigmoid-normal (``reference/ces.py``).  Like
``gen.py``, it imports nothing of the program."""
from __future__ import annotations

import torch

from portbench.reference.ces import prior, response
from portbench.reference.model import Rounder


def ces_batch(gen: torch.Generator, B: int, n_query: int, task: dict):
    """``theta`` [B, 5], candidates ``x`` [B, n_ctx + n_query, 6] and the
    rating ``y`` [B, N, 1] at every candidate."""
    theta = prior(gen, (B,))
    N = task["n_context_init"] + n_query
    x = task["design_scale"] * torch.rand((B, N, 6), generator=gen,
                                          device=gen.device)
    mu, sigma = response(x, theta[:, None], task["noise_scale"],
                         Rounder("float32"))
    eps = torch.randn(mu.shape, generator=gen, device=gen.device)
    e = task["epsilon"]
    y = torch.sigmoid(mu + sigma * eps).clamp(e, 1.0 - e)
    return dict(x=x, y=y[..., None], theta=theta)
