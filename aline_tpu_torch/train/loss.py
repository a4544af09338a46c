"""REINFORCE + prediction loss from a rollout (``aline_tpu/train/loss.py``).

* reward  R_t = gamma^t * clamp(nll_q[t-1] - nll_q[t], min=0), detached,
  for t = 1..T-1;
* R is normalised across the batch per step with the unbiased (ddof=1)
  standard deviation + 1e-9;
* design_loss  = -mean(log_probs[:-1] * R);
* predict_loss = mean(nll_pred over all steps and the batch).

On a data axis (``group``: this rank holds B/n of the B rows) the
normalisation takes the GLOBAL batch's mean and ddof=1 std, from sums
all-reduced over the axis (the mean, then the squared deviations from
it), as JAX's GSPMD computes them: a per-rank std is another function.
The two losses stay the local means; with equal shards the average of
the ranks' gradients is the gradient of the global mean.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from aline_tpu_torch.parallel.collectives import all_reduce
from aline_tpu_torch.train.rollout import RolloutOutputs


def _batch_stats(R: torch.Tensor, group, n_ranks: int):
    """Mean and ddof=1 std over the batch axis (1) of ``R`` [T-1, B],
    over all ranks of ``group`` when one is given."""
    if group is None:
        return (R.mean(dim=1, keepdim=True),
                R.std(dim=1, correction=1, keepdim=True))
    n = R.shape[1] * n_ranks
    mean = all_reduce(R.sum(dim=1, keepdim=True), group=group) / n
    sq = all_reduce(((R - mean) ** 2).sum(dim=1, keepdim=True),
                    group=group)
    return mean, torch.sqrt(sq / (n - 1))


def reinforce_losses(ro: RolloutOutputs, gamma: float, group=None,
                     n_ranks: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(design_loss, predict_loss) scalars; ``group`` of ``n_ranks``
    ranks: the data axis (module docstring)."""
    T = ro.nll_query.shape[0]
    nll_q = ro.nll_query.detach()                            # [T, B]
    gain = torch.clamp(nll_q[:-1] - nll_q[1:], min=0.0)      # [T-1, B]
    discounts = gamma ** torch.arange(1, T, dtype=torch.float32,
                                      device=nll_q.device)   # t = 1..T-1
    R = gain * discounts[:, None]
    mean, std = _batch_stats(R, group, n_ranks)
    R = (R - mean) / (std + 1e-9)
    design_loss = -torch.mean(ro.log_probs[:-1] * R)
    predict_loss = torch.mean(ro.nll_pred)
    return design_loss, predict_loss


def total_loss(ro: RolloutOutputs, gamma: float, alpha_design: float,
               group=None, n_ranks: int = 1
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined loss.  ``alpha_design`` is 0.0 in the burning phase
    (prediction only) and cfg.alpha afterwards; ``group``, ``n_ranks``:
    the data axis, as for ``reinforce_losses``."""
    design_loss, predict_loss = reinforce_losses(ro, gamma, group, n_ranks)
    loss = alpha_design * design_loss + predict_loss
    metrics = dict(
        loss=loss,
        design_loss=design_loss,
        predict_loss=predict_loss,
        likelihood=-predict_loss,
        targeted_likelihood=-torch.mean(ro.nll_query),
    )
    return loss, metrics
