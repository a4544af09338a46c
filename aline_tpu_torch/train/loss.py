"""REINFORCE + prediction loss from a rollout (``aline_tpu/train/loss.py``).

* reward  R_t = gamma^t * clamp(nll_q[t-1] - nll_q[t], min=0), detached,
  for t = 1..T-1;
* R is normalised across the batch per step with the unbiased (ddof=1)
  standard deviation + 1e-9;
* design_loss  = -mean(log_probs[:-1] * R);
* predict_loss = mean(nll_pred over all steps and the batch).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from aline_tpu_torch.train.rollout import RolloutOutputs


def reinforce_losses(ro: RolloutOutputs, gamma: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(design_loss, predict_loss) scalars."""
    T = ro.nll_query.shape[0]
    nll_q = ro.nll_query.detach()                            # [T, B]
    gain = torch.clamp(nll_q[:-1] - nll_q[1:], min=0.0)      # [T-1, B]
    discounts = gamma ** torch.arange(1, T, dtype=torch.float32,
                                      device=nll_q.device)   # t = 1..T-1
    R = gain * discounts[:, None]
    mean = R.mean(dim=1, keepdim=True)
    std = R.std(dim=1, correction=1, keepdim=True)
    R = (R - mean) / (std + 1e-9)
    design_loss = -torch.mean(ro.log_probs[:-1] * R)
    predict_loss = torch.mean(ro.nll_pred)
    return design_loss, predict_loss


def total_loss(ro: RolloutOutputs, gamma: float, alpha_design: float
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined loss.  ``alpha_design`` is 0.0 in the burning phase
    (prediction only) and cfg.alpha afterwards."""
    design_loss, predict_loss = reinforce_losses(ro, gamma)
    loss = alpha_design * design_loss + predict_loss
    metrics = dict(
        loss=loss,
        design_loss=design_loss,
        predict_loss=predict_loss,
        likelihood=-predict_loss,
        targeted_likelihood=-torch.mean(ro.nll_query),
    )
    return loss, metrics
