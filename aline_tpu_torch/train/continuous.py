"""Continuous-design rollouts for the Gaussian-policy head
(``aline_tpu/train/continuous.py``).

Each step the model EMITS a design xi (instead of choosing a pool
candidate), the simulator produces its outcome, and the (xi, y) pair joins
the context.  Batch layout: ``x``/``y`` buffers of width n_ctx0 + T + 1;
the first n_ctx0 slots are the initial context, the next T are filled as
the rollout proceeds, and the LAST slot is the query slot, which the
continuous embedder replaces by its learned design token.  The batch has
no context capacity, so attention takes the generic role-masked path, as
in JAX.

Both noises, the policy's and the simulator's, are drawn before the
rollout (``draw_rollout_noise``) and passed into each step:
``torch.utils.checkpoint`` replays the global RNG but not an explicit
``torch.Generator``, so a draw inside a recomputed step would differ.  The
buffers are written out of place (``torch.where`` on the step's slot): the
pathwise gradient flows through them into every later step.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from aline_tpu_torch.distributions.gmm import gmm_log_prob
from aline_tpu_torch.tasks.base import Batch, Task


class ContinuousRollout(NamedTuple):
    log_probs: torch.Tensor   # [T, B] Gaussian policy log-probs
    nll_query: torch.Tensor   # [T, B]
    nll_pred: torch.Tensor    # [T, B]
    xs: torch.Tensor          # [T, B, dim_x] emitted designs (normalised)
    ys: torch.Tensor          # [T, B, dim_y]
    stds: torch.Tensor        # [T, B, dim_x] policy stds


def make_continuous_batch(task: Task, gen: torch.Generator, batch_size: int,
                          T: int) -> Batch:
    """The initial batch of a continuous rollout, on the generator's
    device: theta, the initial context (normalised designs and their
    outcomes), T empty growth slots and the query slot."""
    B, n_ctx0, dev = batch_size, task.n_context_init, gen.device
    theta = task.sample_theta(gen, (B,))
    x_ctx = task.sample_data(gen, B, n_ctx0)
    y_ctx = task.simulate(gen, task.unnormalise_design(x_ctx),
                          theta[:, None])
    x = torch.cat([x_ctx, x_ctx.new_zeros(B, T + 1, task.dim_x)], dim=1)
    y = torch.cat([y_ctx, y_ctx.new_zeros(B, T + 1, task.dim_y)], dim=1)
    ctx = (torch.arange(n_ctx0 + T + 1, device=dev) < n_ctx0)[None].expand(
        B, -1)
    return Batch(
        x=x, y=y, ctx_mask=ctx,
        target_x=x.new_zeros(B, 0, task.dim_x),
        target_all=theta.reshape(B, task.n_target_theta, 1), theta=theta,
        target_mask=torch.ones(task.n_target_theta, dtype=torch.bool,
                               device=dev),
        t=torch.zeros((), device=dev))


def draw_rollout_noise(task: Task, gen: torch.Generator, T: int,
                       batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(policy noise [T, B, 1, dim_x], simulator noise [T, B, dim_y]),
    standard normal."""
    dev = gen.device
    return (torch.randn(T, batch_size, 1, task.dim_x, generator=gen,
                        device=dev),
            torch.randn(T, batch_size, task.dim_y, generator=gen,
                        device=dev))


def rollout_continuous(model, task: Task, batch: Batch, T: int,
                       w_query: torch.Tensor, w_pred: torch.Tensor,
                       sim_noise: torch.Tensor,
                       design_noise: Optional[torch.Tensor] = None, *,
                       training: bool, time_token: bool = False,
                       use_remat: bool = True) -> ContinuousRollout:
    """T steps of emit design → simulate → append to the context.

    ``sim_noise`` [T, B, dim_y] drives the simulator
    (``task.simulate_from_noise``); ``design_noise`` [T, B, 1, dim_x] the
    policy when ``training`` (greedy designs otherwise).  ``use_remat``
    recomputes each step's activations in the backward pass."""
    n_ctx0 = task.n_context_init
    target_vals = batch.target_all[..., 0]
    slots = torch.arange(batch.n_points, device=batch.x.device)

    def step(x_buf, y_buf, ctx, d_noise, s_noise, tt, t):
        b = batch.replace(x=x_buf, y=y_buf, ctx_mask=ctx, t=tt)
        out = model(b, training=training, noise=d_noise,
                    query_posterior=False)
        xi = out.design_out.xi[:, 0]                         # [B, dim_x]
        y = task.simulate_from_noise(task.unnormalise_design(xi),
                                     batch.theta, s_noise)   # [B, dim_y]
        here = slots == n_ctx0 + t
        x_buf = torch.where(here[None, :, None], xi[:, None], x_buf)
        y_buf = torch.where(here[None, :, None], y[:, None], y_buf)
        ctx = ctx | here[None]
        po = out.posterior_out
        ll = gmm_log_prob(target_vals, po.mixture_means, po.mixture_stds,
                          po.mixture_weights)
        return (out.design_out.log_prob, -torch.sum(ll * w_query, dim=-1),
                -torch.sum(ll * w_pred, dim=-1), xi, y,
                out.design_out.std[:, 0], x_buf, y_buf, ctx)

    x_buf, y_buf, ctx = batch.x, batch.y, batch.ctx_mask
    per_step = []
    for t in range(T):
        tt = torch.full((), t, dtype=torch.float32, device=batch.t.device)
        tt = tt / T if time_token else torch.zeros_like(tt)
        d_noise = design_noise[t] if training else None
        args = (x_buf, y_buf, ctx, d_noise, sim_noise[t], tt)
        if use_remat:
            res = checkpoint(partial(step, t=t), *args, use_reentrant=False)
        else:
            res = step(*args, t=t)
        *outs, x_buf, y_buf, ctx = res
        per_step.append(outs)
    return ContinuousRollout(*(torch.stack(s) for s in zip(*per_step)))
