"""QUEST+/PSI grid-Bayes baseline of the psychometric task
(``aline_tpu/eval/psi.py``).

A product grid over theta = (alpha, beta, gamma, lambda) carries the
exact discrete posterior; each trial updates it with the gathered
Bernoulli log-likelihood column of the chosen stimulus.  The next
stimulus maximises the mutual information I(y; theta_S) between the
outcome and the targeted subset S of the parameters, the nuisance ones
marginalised: I = H_b(p(y)) - E_{theta_S}[H_b(p(y | theta_S))].  The
candidates are the batch's own pre-simulated pool, consumed points
masked, so the designs compare with ALINE's on the same randomness.

The subjects go through in chunks of ``b_chunk`` (4 by default, as in
the JAX package), so that only a [b_chunk, G, N] likelihood block is
alive (170 MB in float32 at b_chunk=4 on the 35,343-cell grid and a
301-point pool); within a chunk the subjects are one batch dimension and
the trials a Python loop that never waits for the host.  The metrics are
those of ``eval/al_curves.py``: the mask-weighted log density of the
true parameters under the grid marginals (piecewise constant) and the
mask-weighted RMSE of the posterior mean.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from aline_tpu_torch.ops.roles import NEG_INF
from aline_tpu_torch.tasks.base import Batch

_EPS = 1e-10  # the Bernoulli clip of PsychometricTask.log_likelihood


def _linspace(start: float, stop: float, n: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, n)`` in float32 as it is written:
    start (1 - i/(n-1)) + stop i/(n-1), then the end point (XLA fuses it
    and rounds some points up to 2 ulps of the end points apart)."""
    s = torch.tensor(start, dtype=torch.float32)
    e = torch.tensor(stop, dtype=torch.float32)
    if n == 1:
        return s[None]
    step = (torch.arange(n - 1, dtype=torch.float32)
            / torch.tensor(float(n - 1)))
    return torch.cat([s * (1 - step) + e * step, e[None]])


def make_theta_grid(task, n_axis: Sequence[int] = (33, 17, 9, 7),
                    device="cpu") -> Dict:
    """The cell-centred product grid over the task's uniform prior box,
    built on the CPU and moved to ``device``: ``axes`` (4 tensors),
    ``widths`` [4], ``shape``, ``theta`` [G, 4] (C order), ``ranges``."""
    ranges = (task.ALPHA_RANGE, task.BETA_RANGE, task.GAMMA_RANGE,
              task.LAMBDA_RANGE)
    axes, widths = [], []
    for (lo, hi), n in zip(ranges, n_axis):
        w = (hi - lo) / n
        axes.append(_linspace(lo + w / 2, hi - w / 2, n))
        widths.append(w)
    mesh = torch.meshgrid(*axes, indexing="ij")
    theta = torch.stack([m.reshape(-1) for m in mesh], dim=-1)
    return {"axes": [a.to(device) for a in axes],
            "widths": torch.tensor(widths, dtype=torch.float32,
                                   device=device),
            "shape": tuple(int(n) for n in n_axis),
            "theta": theta.to(device), "ranges": ranges}


def _binary_entropy(p: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return -(p * torch.log(p) + (1.0 - p) * torch.log1p(-p))


def _metrics(log_post: torch.Tensor, grid, theta_true: torch.Tensor,
             mask_w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-weighted log density at theta_true and posterior-mean RMSE.

    log_post [B, G] unnormalised; theta_true [B, 4]; mask_w [4]
    normalised.  Returns two [B] tensors.
    """
    B = log_post.shape[0]
    shape = grid["shape"]
    lp = log_post - torch.logsumexp(log_post, dim=-1, keepdim=True)
    lp = lp.reshape((B,) + shape)
    lls, sqes = [], []
    for d in range(4):
        other = tuple(1 + i for i in range(4) if i != d)
        log_marg = torch.logsumexp(lp, dim=other)              # [B, n_d]
        axis = grid["axes"][d]
        w = grid["widths"][d]
        lo = grid["ranges"][d][0]
        mean_d = torch.sum(torch.exp(log_marg) * axis, dim=-1)
        cell = torch.clamp(torch.floor((theta_true[:, d] - lo) / w).long(),
                           0, axis.shape[0] - 1)
        lls.append(log_marg.gather(1, cell[:, None])[:, 0] - torch.log(w))
        sqes.append((theta_true[:, d] - mean_d) ** 2)
    ll = torch.sum(torch.stack(lls, dim=-1) * mask_w, dim=-1)
    rmse = torch.sqrt(torch.sum(torch.stack(sqes, dim=-1) * mask_w, dim=-1))
    return ll, rmse


def _subset_layout(shape, subset):
    """(permutation putting the subset's axes first, GS, GN)."""
    nuis = tuple(i for i in range(4) if i not in subset)
    gs = int(np.prod([shape[i] for i in subset]))
    gn = int(np.prod([shape[i] for i in nuis]))
    return tuple(subset) + nuis, gs, gn


def subset_view(P: torch.Tensor, grid, subset) -> torch.Tensor:
    """P [B, G, N] permuted to [B, GS, GN, N]: the subset's grid cells,
    then the nuisance ones (one copy; constant over the trials)."""
    perm, gs, gn = _subset_layout(grid["shape"], subset)
    B, N = P.shape[0], P.shape[-1]
    return (P.reshape((B,) + grid["shape"] + (N,))
            .permute((0,) + tuple(1 + i for i in perm) + (5,))
            .reshape(B, gs, gn, N))


def info_gain(post: torch.Tensor, P: torch.Tensor,
              HbP: Optional[torch.Tensor], grid, subset: Tuple[int, ...],
              P_sub: Optional[torch.Tensor] = None) -> torch.Tensor:
    """I(y; theta_S) [B, N] for every candidate.

    post [B, G]; P [B, G, N]; HbP = H_b(P), read for the full subset
    only; for a strict subset ``P_sub`` is ``subset_view(P)``, built here
    when not given.
    """
    p1 = torch.einsum("bg,bgn->bn", post, P)
    h_marginal = _binary_entropy(p1)
    if len(subset) == 4:
        return h_marginal - torch.einsum("bg,bgn->bn", post, HbP)
    perm, gs, gn = _subset_layout(grid["shape"], subset)
    if P_sub is None:
        P_sub = subset_view(P, grid, subset)
    B = post.shape[0]
    post_r = (post.reshape((B,) + grid["shape"])
              .permute((0,) + tuple(1 + i for i in perm))
              .reshape(B, gs, gn))
    p_s = torch.sum(post_r, dim=-1)                             # [B, GS]
    # p(y=1 | theta_S, x) = E[p(y=1 | theta, x) | theta_S]
    num = torch.einsum("bsg,bsgn->bsn", post_r, P_sub)          # [B, GS, N]
    p1_given_s = num / torch.clamp(p_s[..., None], min=_EPS)
    return h_marginal - torch.einsum("bs,bsn->bn", p_s,
                                     _binary_entropy(p1_given_s))


@torch.no_grad()
def psi_rollout_curves(task, batch: Batch, T: int,
                       gen: Optional[torch.Generator], mask,
                       strategy: str = "psi", grid=None, b_chunk: int = 4
                       ) -> Dict[str, torch.Tensor]:
    """Grid-Bayes rollout of every subject of ``batch`` on its own
    pre-simulated pool, ``b_chunk`` subjects at a time.

    mask: [4] bool target mask; PSI maximises the information about
    exactly these parameters, and the metrics weight them as the ALINE
    eval does.  strategy: ``"psi"`` or ``"random"`` (uniform among the
    unconsumed points).  The random strategy draws its [T, B, N]
    uniforms from ``gen`` once, before the chunks, and each chunk reads
    its own subjects' rows, so its curves do not depend on ``b_chunk``
    (the JAX package splits one key per subject instead).

    Returns ``log_prob`` and ``rmse`` [B, T+1] (step 0: the initial
    context alone) and ``idx`` [B, T], on the batch's device.
    """
    if strategy not in ("psi", "random"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if b_chunk < 1:
        raise ValueError(f"b_chunk must be >= 1, got {b_chunk}")
    dev = batch.x.device
    if grid is None:
        grid = make_theta_grid(task, device=dev)
    mask = np.asarray(mask, bool)
    subset = tuple(int(i) for i in np.flatnonzero(mask))
    # the normalised mask weights, made on the device: a copy from the
    # host, or a write of a Python number into an element, waits for it
    params = torch.arange(4, device=dev)
    sel = torch.zeros(4, dtype=torch.bool, device=dev)
    for i in subset:
        sel = sel | (params == i)
    mask_w = sel.float() * (1.0 / max(len(subset), 1))
    theta_true = batch.target_all[..., 0]                       # [B, 4]
    B = batch.batch_size
    u = (torch.rand((T,) + tuple(batch.ctx_mask.shape), generator=gen,
                    device=dev) if strategy == "random" else None)
    outs = [_rollout_chunk(task, grid, subset, mask_w, strategy, T,
                           batch.x[s:s + b_chunk], batch.y[s:s + b_chunk],
                           batch.ctx_mask[s:s + b_chunk],
                           theta_true[s:s + b_chunk],
                           None if u is None else u[:, s:s + b_chunk])
            for s in range(0, B, b_chunk)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def _rollout_chunk(task, grid, subset, mask_w, strategy, T, x, y, ctx,
                   theta_true, u) -> Dict[str, torch.Tensor]:
    """The T trials of a chunk of subjects (``psi_rollout_curves``); ``u``
    [T, b, N] are the random strategy's uniforms."""
    b = x.shape[0]
    P = task.psychometric_function(
        x[:, None], grid["theta"][None, :, None, :])[..., 0]    # [b, G, N]
    G = P.shape[1]
    HbP = P_sub = None
    if strategy == "psi":
        if len(subset) == 4:
            HbP = _binary_entropy(P)
        else:
            P_sub = subset_view(P, grid, subset)
    y_bin = y[..., 0]                                           # [b, N]
    consumed = ctx.clone()
    ctxf = consumed.float()
    # condition on the initially revealed context points
    log_post = (torch.einsum("bgn,bn->bg", torch.log(P + _EPS),
                             y_bin * ctxf)
                + torch.einsum("bgn,bn->bg", torch.log1p(-P + _EPS),
                               (1.0 - y_bin) * ctxf))

    lls, rmses, idxs = [], [], []
    for t in range(T):
        ll_now, rmse_now = _metrics(log_post, grid, theta_true, mask_w)
        if strategy == "psi":
            gain = info_gain(torch.softmax(log_post, dim=-1), P, HbP, grid,
                             subset, P_sub=P_sub)
            idx = torch.argmax(gain.masked_fill(consumed, NEG_INF), dim=-1)
        else:
            idx = torch.argmax(u[t].masked_fill(consumed, -1.0), dim=-1)
        p_col = P.gather(2, idx[:, None, None].expand(b, G, 1))[..., 0]
        y_sel = y_bin.gather(1, idx[:, None])                   # [b, 1]
        log_post = log_post + torch.where(
            y_sel > 0.5, torch.log(p_col + _EPS), torch.log1p(-p_col + _EPS))
        consumed = consumed.scatter(1, idx[:, None], True)
        lls.append(ll_now)
        rmses.append(rmse_now)
        idxs.append(idx)
    ll_f, rmse_f = _metrics(log_post, grid, theta_true, mask_w)
    return {"log_prob": torch.stack(lls + [ll_f], dim=1),
            "rmse": torch.stack(rmses + [rmse_f], dim=1),
            "idx": (torch.stack(idxs, dim=1) if idxs else
                    torch.zeros(b, 0, dtype=torch.int64, device=x.device))}
