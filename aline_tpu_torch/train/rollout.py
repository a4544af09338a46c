"""The T-step experiment rollout (``aline_tpu/train/rollout.py``).

Per step the model proposes a design, the chosen point's pre-simulated
outcome joins the context, and two NLL streams are recorded: the masked
targets' (the reward signal) and all targets' (the prediction loss).
JAX runs the steps as one ``lax.scan``; here they are a Python loop, and
with ``use_remat`` each step runs under ``torch.utils.checkpoint``, so the
backward pass keeps one step's activations at a time.

Stochastic designs come from Gumbel noise drawn before the rollout and
passed into each step.  ``torch.utils.checkpoint`` restores the global RNG
when it recomputes a step, but not an explicit ``torch.Generator``: a
draw inside the step would give the recomputed step another design, and
its ``log_prob`` would silently belong to another point.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from aline_tpu_torch.distributions.gmm import gmm_log_prob
from aline_tpu_torch.tasks.base import Batch, select_design


class RolloutOutputs(NamedTuple):
    log_probs: torch.Tensor       # [T, B] design log-probs
    nll_query: torch.Tensor       # [T, B] masked-target NLL (reward stream)
    nll_pred: torch.Tensor        # [T, B] all-target NLL (prediction stream)
    idx: torch.Tensor             # [T, B] chosen point indices
    xs: torch.Tensor              # [T, B, dim_x] chosen designs
    ys: torch.Tensor              # [T, B, dim_y] observed outcomes
    final_ctx_mask: torch.Tensor  # [B, n_points]


def rollout(model, batch: Batch, T: int, w_query: torch.Tensor,
            w_pred: torch.Tensor, gumbel: Optional[torch.Tensor] = None, *,
            time_token: bool = False, use_remat: bool = True,
            remat_policy: str = "full",
            sel_targets: Optional[tuple] = None) -> RolloutOutputs:
    """Run T acquisition steps.

    Args:
        w_query/w_pred: [n_target] NLL weight vectors
            (:func:`aline_tpu_torch.ops.target_mask.target_weight_vectors`).
        gumbel: [T, B, n_points] standard Gumbel noise: stochastic designs
            (training); None: greedy argmax designs.
        time_token: feed step t's time scalar t/T to the model (the
            training direction; the AL curves use (T - t)/T).
        use_remat: recompute each step's activations in the backward pass.
        sel_targets: static tuple of the attendable target indices (the
            True set of ``batch.target_mask``) for the compact attention;
            None keeps every target column.  Exact either way.
    """
    if remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={remat_policy!r} is not ported yet (only 'full')")
    target_vals = batch.target_all[..., 0]                   # [B, n_target]
    training = gumbel is not None

    def step(ctx_mask, ctx_idx, noise, t):
        # ctx_idx is carried beside ctx_mask: the compact attention reads
        # it, and leaving it out would freeze the attended key set
        b = batch.replace(ctx_mask=ctx_mask, ctx_idx=ctx_idx, t=t)
        out = model(b, training=training, gumbel=noise,
                    sel_targets=sel_targets, query_posterior=False)
        b2, x_sel, y_sel = select_design(b, out.design_out.idx)
        po = out.posterior_out
        ll = gmm_log_prob(target_vals, po.mixture_means, po.mixture_stds,
                          po.mixture_weights)                # [B, n_target]
        nll_q = -torch.sum(ll * w_query, dim=-1)
        nll_p = -torch.sum(ll * w_pred, dim=-1)
        return (out.design_out.log_prob, nll_q, nll_p, out.design_out.idx,
                x_sel, y_sel, b2.ctx_mask, b2.ctx_idx)

    ctx_mask, ctx_idx = batch.ctx_mask, batch.ctx_idx
    per_step = []
    for t in range(T):
        noise = gumbel[t] if training else None
        tt = (torch.full((), t, dtype=torch.float32,
                         device=batch.t.device) / T
              if time_token else torch.zeros((), device=batch.t.device))
        if use_remat:
            res = checkpoint(step, ctx_mask, ctx_idx, noise, tt,
                             use_reentrant=False)
        else:
            res = step(ctx_mask, ctx_idx, noise, tt)
        *ys, ctx_mask, ctx_idx = res
        per_step.append(ys)
    log_probs, nll_q, nll_p, idx, xs, ys = (torch.stack(s)
                                            for s in zip(*per_step))
    return RolloutOutputs(log_probs, nll_q, nll_p, idx, xs, ys, ctx_mask)
