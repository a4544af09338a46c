"""Trajectory-level EIG bound losses (``aline_tpu/eval/eig_losses.py``).

Given whole trajectories and a block of contrastive thetas (theta_0 at
index 0), the sPCE and sNMC losses and the score-gradient sPCE: the dense
"all thetas at once" forms that train continuous-design policies; the
streaming evaluation is ``eval/eig.py``.
"""
from __future__ import annotations

import torch


def compute_seq_logprobs(task, y_outcomes, xi_designs, thetas):
    """[L, B] trajectory log-likelihoods of y_outcomes [B, T, 1] at
    xi_designs [B, T, D] under thetas [L, B, ...] (index 0 = theta_0)."""
    ll = task.log_likelihood(y_outcomes[None], xi_designs[None],
                             thetas.unsqueeze(2))            # [L, B, T, 1]
    return torch.sum(ll, dim=(-2, -1))


def _reduce(loss, reduction):
    return torch.mean(loss) if reduction == "mean" else loss


def pce_loss(task, y_outcomes, xi_designs, thetas, reduction="mean"):
    """sPCE loss (the negated bound without its constant)."""
    lp = compute_seq_logprobs(task, y_outcomes, xi_designs, thetas)
    return _reduce(torch.logsumexp(lp, dim=0) - lp[0], reduction)


def nmc_loss(task, y_outcomes, xi_designs, thetas, reduction="mean"):
    """sNMC loss: theta_0 left out of the logsumexp."""
    lp = compute_seq_logprobs(task, y_outcomes, xi_designs, thetas)
    return _reduce(torch.logsumexp(lp[1:], dim=0) - lp[0], reduction)


def pce_loss_score_gradient(task, y_outcomes, xi_designs, thetas,
                            reduction="mean"):
    """Score-gradient estimator of the sPCE loss."""
    lp = compute_seq_logprobs(task, y_outcomes, xi_designs, thetas)
    lp_primary = lp[0]
    lse = torch.logsumexp(lp, dim=0)
    g_no_grad = (lp_primary - lse).detach()
    return _reduce(-(g_no_grad * lp_primary - lse), reduction)
