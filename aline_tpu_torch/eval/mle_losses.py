"""Posterior maximum-likelihood losses and sample distances
(``aline_tpu/eval/mle_losses.py``).

Analysis capabilities, on no training or evaluation path (in the JAX
package either).  They take a ``log_prob_fn(values) -> log-densities`` or
explicit Normal parameters.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from aline_tpu_torch.distributions.gmm import normal_log_prob


def _reduce(x, reduction):
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction == "logsumexp":
        return torch.logsumexp(x, dim=0)
    return x


def nmle_loss(log_prob_fn: Callable, target: torch.Tensor,
              reduction: str = "mean"):
    """Negative posterior log-likelihood, summed over each row."""
    lp = log_prob_fn(target)                                 # [B, ...]
    return -_reduce(torch.sum(lp.reshape(lp.shape[0], -1), dim=1),
                    reduction)


def sorted_nmle_loss(loc, scale, target, reduction: str = "mean"):
    """Order-matched NMLE for exchangeable latents: targets and predicted
    locations sorted along the set axis.  loc/scale/target: [B, K, D]."""
    target = torch.sort(target, dim=1).values
    order = torch.argsort(loc, dim=1)
    loc = torch.take_along_dim(loc, order, dim=1)
    scale = torch.take_along_dim(scale, order, dim=1)
    lp = normal_log_prob(target, loc, scale)
    return -_reduce(torch.sum(lp.reshape(lp.shape[0], -1), dim=1),
                    reduction)


def _pair_log_probs(loc, scale, target):
    """[B, K, K]: target k under component j, summed over D."""
    return normal_log_prob(target[:, :, None, :], loc[:, None, :, :],
                           scale[:, None, :, :]).sum(-1)


def chamfer_nmle_loss(loc, scale, target, reduction: str = "mean"):
    """Chamfer-style permutation-invariant NMLE: symmetric best-match
    log-probs between the K components and the K targets."""
    lp = _pair_log_probs(loc, scale, target)
    score = (torch.amax(lp, dim=1).sum(-1)
             + torch.amax(lp, dim=2).sum(-1)) / 2.0          # [B]
    return -_reduce(score, reduction)


def set_nmle_loss(loc, scale, target, reduction: str = "mean"):
    """Logsumexp set-matching NMLE lower bound (mean over the batch)."""
    lp = torch.logsumexp(_pair_log_probs(loc, scale, target),
                         dim=-1).sum(-1)                     # [B]
    return -torch.mean(lp)


def l2_distance(gen: Optional[torch.Generator], loc, scale, target,
                N: int = 1000, reduction: str = "mean",
                eps: Optional[torch.Tensor] = None):
    """Expected sorted-sample L2 distance between N posterior samples and
    the true latents.  loc/scale/target: [B, K, D]; ``eps`` [N, B, K, D]
    standard-normal draws, else drawn from ``gen``."""
    if eps is None:
        eps = torch.randn((N,) + tuple(loc.shape), generator=gen,
                          device=loc.device, dtype=loc.dtype)
    samples = (loc[None] + scale[None] * eps).movedim(0, 1)  # [B, N, K, D]
    samples = torch.sort(samples, dim=-2).values
    target = torch.sort(target[:, None], dim=-2).values      # [B, 1, K, D]
    l2 = torch.linalg.vector_norm(target - samples, dim=-1)  # [B, N, K]
    return _reduce(torch.mean(torch.sum(l2, dim=-1), dim=-1), reduction)
