"""The T-step experiment rollout (``aline_tpu/train/rollout.py``).

Per step the model proposes a design, the chosen point's pre-simulated
outcome joins the context, and two NLL streams are recorded: the masked
targets' (the reward signal) and all targets' (the prediction loss).
JAX runs the steps as one ``lax.scan``; here they are a Python loop, and
with ``use_remat`` each step runs under ``torch.utils.checkpoint``, so the
backward pass keeps one step's activations at a time.

``remat_policy="dots"`` is JAX's ``dots_with_no_batch_dims_saveable``:
a selective checkpoint that keeps the outputs of the dense products
without a batch dimension (``aten.mm``, ``aten.addmm``: the layers'
weight products) and recomputes everything else, the batched attention
products included.  The values are those of ``full``; only memory and
time change.  The kernels' autograd functions are recomputed under it.

Stochastic designs come from Gumbel noise drawn before the rollout and
passed into each step.  ``torch.utils.checkpoint`` restores the global RNG
when it recomputes a step, but not an explicit ``torch.Generator``: a
draw inside the step would give the recomputed step another design, and
its ``log_prob`` would silently belong to another point.  So the step
draws nothing, and while a CUDA graph captures it (``train/graph.py``,
the trainer's path on the card) the checkpoint does not save the RNG
state either, which a capture may not read.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from aline_tpu_torch.distributions.gmm import gmm_log_prob
from aline_tpu_torch.tasks.base import Batch, select_design
from aline_tpu_torch.utils.metrics import span


REMAT_POLICIES = ("full", "dots")

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the products without a batch dimension, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint_kwargs(remat_policy: str) -> dict:
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={remat_policy!r}; one of "
                         f"{REMAT_POLICIES}")
    if remat_policy == "dots":
        return dict(context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    return {}


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
            time_token: bool = False, time_forward: bool = True,
            use_remat: bool = True,
            remat_policy: str = "full",
            sel_targets: Optional[tuple] = None) -> RolloutOutputs:
    """Run T acquisition steps.

    Args:
        w_query/w_pred: [n_target] NLL weight vectors
            (:func:`aline_tpu_torch.ops.target_mask.target_weight_vectors`).
        gumbel: [T, B, n_points] standard Gumbel noise: stochastic designs
            (training); None: greedy argmax designs.
        time_token: feed step t's time scalar to the model.
        time_forward: the scalar counts up, t/T (the training direction);
            False: down, (T - t)/T (the eval direction of ``aline_tpu``,
            ``eval/traces.py``).
        use_remat: recompute each step's activations in the backward pass.
        remat_policy: what ``use_remat`` keeps (``full``: nothing;
            ``dots``: the weight products, module docstring).
        sel_targets: static tuple of the attendable target indices (the
            True set of ``batch.target_mask``) for the compact attention;
            None keeps every target column.  Exact either way.
    """
    ckpt_kw = _checkpoint_kwargs(remat_policy)
    if batch.x.is_cuda and torch.cuda.is_current_stream_capturing():
        # a capture may not read the CUDA generator's state; the step
        # draws nothing, so there is nothing to restore (``train/graph.py``)
        ckpt_kw["preserve_rng_state"] = False
    target_vals = batch.target_all[..., 0]                   # [B, n_target]
    training = gumbel is not None

    def step(ctx_mask, ctx_idx, noise, t):
        # the span is inside the checkpointed function: a recomputed step
        # is traced again, under the backward pass
        with span("rollout.step"):
            # ctx_idx is carried beside ctx_mask: the compact attention
            # reads it, and leaving it out would freeze the attended keys
            b = batch.replace(ctx_mask=ctx_mask, ctx_idx=ctx_idx, t=t)
            out = model(b, training=training, noise=noise,
                        sel_targets=sel_targets, query_posterior=False)
            b2, x_sel, y_sel = select_design(b, out.design_out.idx)
            po = out.posterior_out
            ll = gmm_log_prob(target_vals, po.mixture_means,
                              po.mixture_stds,
                              po.mixture_weights)            # [B, n_target]
            nll_q = -torch.sum(ll * w_query, dim=-1)
            nll_p = -torch.sum(ll * w_pred, dim=-1)
            return (out.design_out.log_prob, nll_q, nll_p,
                    out.design_out.idx, x_sel, y_sel, b2.ctx_mask,
                    b2.ctx_idx)

    ctx_mask, ctx_idx = batch.ctx_mask, batch.ctx_idx
    per_step = []
    for t in range(T):
        noise = gumbel[t] if training else None
        if time_token:
            tt = torch.full((), t, dtype=torch.float32,
                            device=batch.t.device)
            tt = (tt if time_forward else T - tt) / T
        else:
            tt = torch.zeros((), device=batch.t.device)
        if use_remat:
            res = checkpoint(step, ctx_mask, ctx_idx, noise, tt,
                             use_reentrant=False, **ckpt_kw)
        else:
            res = step(ctx_mask, ctx_idx, noise, tt)
        *ys, ctx_mask, ctx_idx = res
        per_step.append(ys)
    log_probs, nll_q, nll_p, idx, xs, ys = (torch.stack(s)
                                            for s in zip(*per_step))
    return RolloutOutputs(log_probs, nll_q, nll_p, idx, xs, ys, ctx_mask)
