"""The psychometric experiment, plainly: the subject, the reference's
replay of a live experiment, and its control.

A subject has a threshold alpha, a slope beta, a guess rate gamma and a
lapse rate lambda, each uniform on its range (``RANGES``, the task's of
the code release).  Shown a stimulus x, the subject answers 1 with
probability

    p(x) = lambda * gamma + (1 - lambda) * F(x),
    F(x) = 1 - exp(-10^((x - alpha) / beta)),

as the code release's simulator writes it, and 0 otherwise: the answer
to a trial is 1 where the trial's uniform draw u is below p(x).  The
answer is computed on the host in double precision (``respond``), where a
live experiment computes it, from the stimulus the host was shown.

``replay`` teacher-forces what the program showed and was answered
through ``model.forward`` (``rollouts.judge_rollout``), with the target
mask's selected targets and the target weights: the gap of each shown
stimulus below the reference's argmax, and the reference's posterior
curves at the subject's parameters.  ``control`` runs the experiment
with the reference's own choices and answers, and reads the same gaps for
a lower precision.  Both run in float32 with TF32 off (the configuration's
precision by the ``Rounder``s), import nothing of the program and use no
kernel of it.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.model import Inputs, forward, posterior_curves
from portbench.reference.rollouts import judge_rollout, scores

# threshold, slope, guess rate, lapse rate
RANGES = ((-3.0, 3.0), (0.1, 2.0), (0.1, 0.9), (0.0, 0.5))
N_THETA = len(RANGES)


def probability(x: float, theta) -> float:
    """p(x) of the subject ``theta`` (alpha, beta, gamma, lambda)."""
    alpha, beta, gamma, lam = (float(v) for v in theta)
    z = (float(x) - alpha) / beta
    F = 1.0 if z > 300.0 else 1.0 - math.exp(-10.0 ** z)
    return lam * gamma + (1.0 - lam) * F


def respond(x: float, theta, u: float) -> float:
    """The subject's answer to stimulus ``x`` on a trial of uniform
    ``u``: 1.0 or 0.0."""
    return 1.0 if float(u) < probability(x, theta) else 0.0


def _no_tf32():
    # no TF32 anywhere in the process, as the program's device sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(x, y, mask):
    return Inputs(x, y, x.new_zeros(x.shape[0], 0, x.shape[-1]), N_THETA,
                  mask)


def _ctx0(x, n_ctx: int):
    c = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
    c[:, :n_ctx] = True
    return c


@torch.no_grad()
def replay(P, x, y0, idx, answers, theta, mask, w, prec, arch):
    """Replay b experiments of one target mask: candidates x [b, N, 1],
    the initial context's answers y0 [b, n_ctx], the stimuli shown idx
    [b, T] and their answers [b, T], parameters theta [b, 4], the mask
    [4] and target weights w [4].  Returns ``judge_rollout``'s ``gap``
    [b, T], ``invalid``, ``log_prob`` and ``rmse`` [b, T + 1]."""
    _no_tf32()
    n_ctx = y0.shape[1]
    y = torch.zeros(x.shape[:2], device=x.device)
    y[:, :n_ctx] = y0
    y = y.scatter(1, idx, answers)[..., None]
    return judge_rollout(P, _inputs(x, y, mask), _ctx0(x, n_ctx), theta, w,
                         idx.shape[1], idx, "aline", prec, arch)


@torch.no_grad()
def control(P, x, y0, theta, u, mask, w, prec_ref, prec_ctl, arch):
    """Run b experiments of one mask with the reference's own choices and
    the subjects' answers (their trials' uniforms u [b, T]); at each trial
    read the gap, under the reference, of the stimulus that ``prec_ctl``
    puts first, and at the end the posterior's curves in ``prec_ctl``
    against the reference's.  Returns (widest design gap, |log-prob gap|
    [b], |RMSE gap| [b])."""
    _no_tf32()
    b, n_ctx, T = x.shape[0], y0.shape[1], u.shape[1]
    rows = torch.arange(b, device=x.device)
    y = torch.zeros(x.shape[:2], device=x.device)
    y[:, :n_ctx] = y0
    ctx = _ctx0(x, n_ctx)
    gap = 0.0
    for t in range(T + 1):
        inp = _inputs(x, y[..., None], mask)
        ref = forward(P, inp, ctx, prec_ref, arch)
        ctl = forward(P, inp, ctx, prec_ctl, arch)
        if t == T:
            break
        s_ref = scores(ref, "aline", ctx)
        c = scores(ctl, "aline", ctx).argmax(-1)
        gap = max(gap, float((s_ref.max(-1).values - s_ref[rows, c]).max()))
        i = s_ref.argmax(-1)
        xs, th, us = x[rows, i, 0].tolist(), theta.tolist(), u[:, t].tolist()
        y[rows, i] = torch.tensor([respond(a, s, v) for a, s, v
                                   in zip(xs, th, us)], device=x.device)
        ctx = ctx.clone()
        ctx[rows, i] = True
    lp_r, rm_r = posterior_curves(ref["target"], theta, w)
    lp_c, rm_c = posterior_curves(ctl["target"], theta, w)
    return gap, (lp_c - lp_r).abs(), (rm_c - rm_r).abs()
