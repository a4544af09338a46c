"""Amortized active-learning evaluation curves
(``aline_tpu/eval/al_curves.py``).

Roll the trained model out for T steps under an acquisition strategy and
record the per-step targeted log-likelihood and RMSE:

* ``aline``       — the model's own policy (greedy argmax),
* ``random``      — uniform choice among the remaining pool points,
* ``uncertainty`` — argmax of the GMM predictive variance over the pool.

**On the card, one CUDA graph a rollout.**  Every tensor of a rollout
keeps its shape at every step (the context buffer is ``init_ctx_idx``'s,
of fixed capacity; only the values of ``ctx_mask`` and ``ctx_idx``
change), and no step reads a device value on the host, so the T steps and
the final forward are captured once as one graph and replayed.  A
rollout of a strategy that draws no random numbers (``GRAPHED``) on CUDA
tensors takes the graph of its key (``graph_key``): the first call with a
key copies the inputs into static buffers, runs the rollout eagerly on a
side stream (that pass warms up every lazy state and is the call's
result) and captures it; a later call copies its inputs into the buffers,
replays the graph and returns clones of the graph's outputs, which the
next replay overwrites.  Graph and eager rollouts launch the same kernels
in the same order on the same inputs: their results are the same bits.
The graphs of one model are kept at a time, while it lives
(``utils/graphs.py`` ``inference_graphs``, shared with ``eval/live.py``'s
trials): a capture for another model drops them, since their pool keeps
the memory of their largest rollout.  All graphs of a model draw their
memory from that one pool; a replay's outputs are cloned before any
other graph runs, which is what makes the sharing safe (one thread at a
time).  CPU tensors, and the ``random`` strategy, run the steps eagerly.

A step's body (``rollout_step``: the forward, the choice, ``select_design``)
and the posterior's curves (``posterior_curves``) are those of a live
trial too.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from aline_tpu_torch.distributions.gmm import gmm_log_prob, gmm_variance
from aline_tpu_torch.eval.metrics import compute_rmse
from aline_tpu_torch.tasks.base import Batch, init_ctx_idx, select_design
from aline_tpu_torch.utils.graphs import (
    Captured,
    addresses,
    batch_form,
    form,
    inference_graphs,
    side_stream,
    tensor_inputs,
)
from aline_tpu_torch.utils.metrics import count, span

STRATEGIES = ("aline", "random", "uncertainty")
# ``random`` draws from the caller's generator, whose state a replay would
# have to advance as the eager steps do: it stays eager.
GRAPHED = ("aline", "uncertainty")


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
    last step's.  On CUDA tensors a ``GRAPHED`` strategy replays a CUDA
    graph of the rollout (the module's docstring).

    Returns ``log_prob`` [B, T+1] and ``rmse`` [B, T+1] (step 0 = before
    any acquisition) and ``idx`` [B, T].
    """
    with span("al.rollout"):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        args = (T, strategy, time_token, *fixed_by_batch(batch))
        if batch.x.is_cuda and strategy in GRAPHED:
            return _graphed(model, batch, target_weights, args)
        return _rollout(model, batch, target_weights, generator, *args)


def fixed_by_batch(batch: Batch) -> tuple:
    """(sel_targets, n_ctx0): what a rollout fixes from the batch's values
    before its first step, by two host reads.  The eval mask is fixed for
    the whole rollout, so the compact attention path may drop the target
    key columns it never shows: ``sel_targets`` are the mask's selected
    targets (None for all of them); ``n_ctx0`` is the initial context
    size."""
    sel_targets = tuple(int(i) for i in
                        torch.nonzero(batch.target_mask)[:, 0].tolist())
    if len(sel_targets) == batch.n_target:
        sel_targets = None
    return sel_targets, int(batch.ctx_mask[0].sum())


def _rollout(model, batch: Batch, target_weights, generator, T, strategy,
             time_token, sel_targets, n_ctx0) -> Dict[str, torch.Tensor]:
    """The rollout's steps, eagerly, with ``fixed_by_batch``'s values."""
    b = init_ctx_idx(batch, min(n_ctx0 + T, batch.n_points))
    target_vals = b.target_all[..., 0]
    target_weights = weights_of(b, target_weights)
    lps, rmses, idxs = [], [], []

    def choose(out, b):
        lp, rmse = posterior_curves(out.posterior_out, target_vals,
                                    target_weights)
        lps.append(lp)
        rmses.append(rmse)
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

    for t in range(T):
        if time_token:
            b = b.replace(t=(T - torch.full((), t, dtype=torch.float32,
                                            device=b.t.device)) / T)
        _, idx, b = rollout_step(model, b, sel_targets, choose)
        idxs.append(idx)
    out = model(b, training=False, sel_targets=sel_targets)
    with span("al.choose"):
        lp, rmse = posterior_curves(out.posterior_out, target_vals,
                                    target_weights)
    B = batch.batch_size
    return {
        "log_prob": torch.stack(lps + [lp], dim=1),
        "rmse": torch.stack(rmses + [rmse], dim=1),
        "idx": (torch.stack(idxs, dim=1) if idxs else
                torch.zeros(B, 0, dtype=torch.int64,
                            device=batch.x.device)),
    }


def rollout_step(model, b: Batch, sel_targets, choose):
    """One step of a rollout, and of a live trial (``eval/live.py``): the
    forward at ``b``, ``choose(out, b)``'s designs [B], and ``b`` with them
    moved into the context.  Returns (the forward's output, the designs,
    the next batch)."""
    out = model(b, training=False, sel_targets=sel_targets)
    with span("al.choose"):
        idx = choose(out, b)
    with span("al.select"):
        b, _, _ = select_design(b, idx)
    return out, idx, b


def weights_of(batch: Batch, target_weights) -> torch.Tensor:
    """The targets' weights of the curves: ``target_weights``, else the
    batch's target mask normalised."""
    if target_weights is not None:
        return target_weights
    m = batch.target_mask.float()
    return m / torch.clamp(m.sum(), min=1.0)


def posterior_curves(po, target_vals: torch.Tensor,
                     target_weights: torch.Tensor):
    """(targeted log-prob [B], weighted RMSE [B]) of the targets' values
    [B, n_target] under the GMM ``po`` (``posterior_out``)."""
    ll = gmm_log_prob(target_vals, po.mixture_means, po.mixture_stds,
                      po.mixture_weights)
    lp = torch.sum(ll * target_weights[None], dim=-1)
    rmse = compute_rmse(target_vals, po.mixture_means, po.mixture_stds,
                        po.mixture_weights, target_weights=target_weights)
    return lp, rmse


def graph_key(model, batch: Batch, target_weights, T: int, strategy: str,
              time_token: bool, sel_targets, n_ctx0: int) -> tuple:
    """What a captured rollout of ``model`` depends on besides the values
    of its inputs: the strategy, T, the time token, the selected targets
    and the initial context size; the shape, dtype and device of every
    tensor field of the batch (and of the target weights) and its integer
    fields; the addresses of the model's parameters and buffers, which the
    graph reads, so that a model whose tensors were replaced is captured
    anew.  (The model itself keys the cache the key is looked up in.)"""
    return (strategy, T, time_token, sel_targets, n_ctx0, batch_form(batch),
            form(target_weights), addresses(model))


# model → its rollouts' graphs (``utils/graphs.py`` ``Graphs``, keyed by
# ``graph_key``), one model at a time; ``eval/live.py``'s trials share it
_graphs = inference_graphs


def _graphed(model, batch: Batch, target_weights, args):
    """The rollout through the graph of its key: replayed, or captured
    on the key's first call."""
    key = graph_key(model, batch, target_weights, *args)
    graphs = _graphs.of(model)
    inputs = tensor_inputs(batch, target_weights=target_weights)
    g = graphs.graphs.get(key)
    if g is not None:
        count("al.graph_replays", 1)
        g.load(inputs)
        g.replay()
        return {n: t.clone() for n, t in g.outputs.items()}

    def run(static):
        tw = static.get("target_weights")
        b = batch.replace(**{n: t for n, t in static.items()
                             if n != "target_weights"})
        return _rollout(model, b, tw, None, *args)

    g = Captured(inputs)
    first = g.capture(run, side_stream(batch.x.device), graphs.handle)
    graphs.graphs[key] = g
    count("al.graph_captures", 1)
    return first


def compare_strategies(model, batch: Batch, T: int,
                       generator: Optional[torch.Generator] = None,
                       strategies=STRATEGIES, **kw):
    """Several acquisition strategies on the SAME batch."""
    return {s: al_rollout_curves(model, batch, T, generator, strategy=s,
                                 **kw)
            for s in strategies}
