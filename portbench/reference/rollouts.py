"""The reference replayed along a rollout: the active-learning curves
and designs, and the greedy BED traces.

``judge_rollout`` follows the designs that the program chose and, at each
step, reads how far the chosen design's score lies below the reference's
best (0 where the program chose the reference's argmax), together with
the reference's posterior curves.  ``control_rollout`` follows the
reference's own choices and reads the same gaps for the designs that a
lower precision puts first, and the curves of that lower precision.
"""
from __future__ import annotations

import torch

from portbench.reference.model import (
    Inputs,
    forward,
    gmm_variance,
    posterior_curves,
)


def scores(out, strategy: str, ctx: torch.Tensor) -> torch.Tensor:
    """[B, Np] what the strategy maximises over the pool (-inf off it):
    the design log-probabilities (``aline``), the log of the pool
    posterior's variance (``uncertainty``), or 0 (``random``)."""
    off = torch.full(ctx.shape, -torch.inf, device=ctx.device)
    if strategy == "aline":
        return torch.where(~ctx, out["log_probs"], off)
    if strategy == "uncertainty":
        var = gmm_variance(*out["pool"]).clamp(min=1e-30)
        return torch.where(~ctx, torch.log(var), off)
    if strategy == "random":
        return torch.where(~ctx, torch.zeros_like(off), off)
    raise ValueError(f"unknown strategy {strategy!r}")


def _select(ctx, idx):
    ctx = ctx.clone()
    ctx[torch.arange(ctx.shape[0], device=ctx.device), idx] = True
    return ctx


@torch.no_grad()
def judge_rollout(P, inp: Inputs, ctx0, targets, w, T: int,
                  idx: torch.Tensor, strategy: str, prec, arch,
                  curves: bool = True):
    """Replay the program's designs ``idx`` [B, T].  Returns ``gap`` [B, T]
    (best score minus the chosen design's, under the reference),
    ``invalid`` (choices of a point already in the context), and with
    ``curves`` the reference's ``log_prob`` and ``rmse`` [B, T + 1]."""
    ctx = ctx0.clone()
    gaps, lps, rmses = [], [], []
    invalid = 0
    for t in range(T + 1):
        last = t == T
        if last and not curves:
            break
        out = forward(P, inp, ctx, prec, arch,
                      pool_posterior=strategy == "uncertainty" and not last)
        if curves:
            lp, rm = posterior_curves(out["target"], targets, w)
            lps.append(lp)
            rmses.append(rm)
        if last:
            break
        s = scores(out, strategy, ctx)
        i = idx[:, t]
        taken = ctx.gather(1, i[:, None])[:, 0]
        invalid += int(taken.sum())
        chosen = s.gather(1, i[:, None])[:, 0]
        gaps.append(torch.where(taken, torch.zeros_like(chosen),
                                s.max(-1).values - chosen))
        ctx = _select(ctx, i)
    res = dict(gap=torch.stack(gaps, 1), invalid=invalid)
    if curves:
        res.update(log_prob=torch.stack(lps, 1), rmse=torch.stack(rmses, 1))
    return res


@torch.no_grad()
def control_rollout(P, inp: Inputs, ctx0, targets, w, T: int,
                    strategy: str, prec_ref, prec_ctl, arch,
                    gen: torch.Generator, curves: bool = True):
    """Follow the reference's own choices (``random``: uniform over the
    pool from ``gen``); at each step read the gap, under the reference, of
    the design that ``prec_ctl`` puts first, and the control's curves
    beside the reference's.  Returns ``gap`` [B, T], the designs followed
    ``idx`` [B, T] and, with ``curves``, ``log_prob_gap`` and ``rmse_gap``
    [B, T + 1]."""
    ctx = ctx0.clone()
    gaps, lp_gaps, rm_gaps, chosen = [], [], [], []
    for t in range(T + 1):
        last = t == T
        if last and not curves:
            break
        pool = strategy == "uncertainty" and not last
        ref = forward(P, inp, ctx, prec_ref, arch, pool_posterior=pool)
        ctl = forward(P, inp, ctx, prec_ctl, arch, pool_posterior=pool)
        if curves:
            lp_r, rm_r = posterior_curves(ref["target"], targets, w)
            lp_c, rm_c = posterior_curves(ctl["target"], targets, w)
            lp_gaps.append((lp_c - lp_r).abs())
            rm_gaps.append((rm_c - rm_r).abs())
        if last:
            break
        s_ref = scores(ref, strategy, ctx)
        if strategy == "random":
            i = torch.multinomial((~ctx).float(), 1, generator=gen)[:, 0]
        else:
            c = scores(ctl, strategy, ctx).argmax(-1)
            gaps.append(s_ref.max(-1).values
                        - s_ref.gather(1, c[:, None])[:, 0])
            i = s_ref.argmax(-1)
        chosen.append(i)
        ctx = _select(ctx, i)
    res = dict(gap=(torch.stack(gaps, 1) if gaps
                    else torch.zeros(ctx.shape[0], 0, device=ctx.device)),
               idx=torch.stack(chosen, 1))
    if curves:
        res.update(log_prob_gap=torch.stack(lp_gaps, 1),
                   rmse_gap=torch.stack(rm_gaps, 1))
    return res
