"""Posterior-quality metrics (``aline_tpu/eval/metrics.py``)."""
from __future__ import annotations

import torch

from aline_tpu_torch.distributions.gmm import gmm_mean


def compute_rmse(target_values, mixture_means, mixture_stds,
                 mixture_weights, target_weights=None):
    """RMSE of the mixture mean vs the targets, optionally weighted per
    target → [B]."""
    del mixture_stds
    pred = gmm_mean(mixture_means, mixture_weights)          # [B, n_target]
    vals = (target_values[..., 0] if target_values.ndim == 3
            else target_values)
    sq = (vals - pred) ** 2
    if target_weights is not None:
        w = target_weights / torch.clamp(target_weights.sum(), min=1e-12)
        return torch.sqrt(torch.sum(sq * w[None], dim=-1))
    return torch.sqrt(torch.mean(sq, dim=-1))
