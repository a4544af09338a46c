"""Amortized active-learning evaluation curves
(``aline_tpu/eval/al_curves.py``).

Roll the trained model out for T steps under an acquisition strategy and
record the per-step targeted log-likelihood and RMSE:

* ``aline``       — the model's own policy (greedy argmax),
* ``random``      — uniform choice among the remaining pool points,
* ``uncertainty`` — argmax of the GMM predictive variance over the pool.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from aline_tpu_torch.distributions.gmm import gmm_log_prob, gmm_variance
from aline_tpu_torch.eval.metrics import compute_rmse
from aline_tpu_torch.tasks.base import Batch, init_ctx_idx, select_design
from aline_tpu_torch.utils.metrics import span

STRATEGIES = ("aline", "random", "uncertainty")


@torch.no_grad()
def al_rollout_curves(model, batch: Batch, T: int,
                      generator: Optional[torch.Generator] = None,
                      strategy: str = "aline",
                      target_weights: Optional[torch.Tensor] = None,
                      time_token: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """Strategy rollout with per-step posterior-quality curves.

    ``generator`` drives the ``random`` strategy.  ``target_weights``:
    optional [n_target] weights for the targeted log-prob; defaults to
    the batch's target_mask normalised.  ``time_token``: step t feeds the
    time scalar (T - t)/T to the model, the eval direction of
    ``aline_tpu`` (training counts up, t/T); the final forward keeps the
    last step's.

    Returns ``log_prob`` [B, T+1] and ``rmse`` [B, T+1] (step 0 = before
    any acquisition) and ``idx`` [B, T].
    """
    with span("al.rollout"):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        # The eval mask is fixed for the whole rollout: the compact attention
        # path may drop the target key columns it never shows.
        sel_targets = tuple(int(i) for i in
                            torch.nonzero(batch.target_mask)[:, 0].tolist())
        if len(sel_targets) == batch.n_target:
            sel_targets = None
        n_ctx0 = int(batch.ctx_mask[0].sum())
        b = init_ctx_idx(batch, min(n_ctx0 + T, batch.n_points))
        target_vals = b.target_all[..., 0]
        if target_weights is None:
            m = b.target_mask.float()
            target_weights = m / torch.clamp(m.sum(), min=1.0)

        def posterior_metrics(out):
            po = out.posterior_out
            ll = gmm_log_prob(target_vals, po.mixture_means, po.mixture_stds,
                              po.mixture_weights)
            lp = torch.sum(ll * target_weights[None], dim=-1)
            rmse = compute_rmse(target_vals, po.mixture_means, po.mixture_stds,
                                po.mixture_weights,
                                target_weights=target_weights)
            return lp, rmse

        def choose(out, b):
            pool = b.query_mask
            if strategy == "aline":
                return out.design_out.idx
            if strategy == "random":
                return torch.multinomial(pool.float(), 1,
                                         generator=generator)[:, 0]
            pq = out.posterior_out_query
            var = gmm_variance(pq.mixture_means, pq.mixture_stds,
                               pq.mixture_weights)                 # [B, P]
            return torch.argmax(torch.where(
                pool, var, torch.full((), -torch.inf, device=var.device)),
                dim=-1)

        lps, rmses, idxs = [], [], []
        for t in range(T):
            if time_token:
                b = b.replace(t=(T - torch.full((), t, dtype=torch.float32,
                                                device=b.t.device)) / T)
            out = model(b, training=False, sel_targets=sel_targets)
            with span("al.choose"):
                lp, rmse = posterior_metrics(out)
                idx = choose(out, b)
            with span("al.select"):
                b, _, _ = select_design(b, idx)
            lps.append(lp)
            rmses.append(rmse)
            idxs.append(idx)
        out = model(b, training=False, sel_targets=sel_targets)
        with span("al.choose"):
            lp, rmse = posterior_metrics(out)
        B = batch.batch_size
        return {
            "log_prob": torch.stack(lps + [lp], dim=1),
            "rmse": torch.stack(rmses + [rmse], dim=1),
            "idx": (torch.stack(idxs, dim=1) if idxs else
                    torch.zeros(B, 0, dtype=torch.int64,
                                device=batch.x.device)),
        }


def compare_strategies(model, batch: Batch, T: int,
                       generator: Optional[torch.Generator] = None,
                       strategies=STRATEGIES, **kw):
    """Several acquisition strategies on the SAME batch."""
    return {s: al_rollout_curves(model, batch, T, generator, strategy=s,
                                 **kw)
            for s in strategies}
