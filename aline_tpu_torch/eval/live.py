"""A live experiment, one trial at a time: the policy proposes a design,
the caller shows it to a subject whose response does not exist until then
(a person at a screen, in the paper's psychometric experiments), and the
response goes into the context before the next proposal.

    s = LiveExperiment(model, batch, T)
    for _ in range(T):
        idx, x = s.propose()          # the next design, on the host
        s.observe(respond(x))         # the subject's response to it
    post = s.posterior()              # the GMM over the targets

``batch`` holds the candidate designs (the initial context first) and the
initial context's outcomes.  The outcomes of the other candidates are never
read: the session keeps its own outcome buffer, zero until a response is
observed (the model reads a point's outcome only while it is context).

**A trial** (``_trial``) writes the last response into the outcomes at the
last design, then runs the rollout's step (``al_curves.rollout_step``: the
forward, the policy's argmax, ``select_design``) and gathers the new
design's index and value into one tensor for the host.  The first trial's
write puts the initial context's last outcome back where it is, so every
trial, the first too, is the same step.  ``posterior`` runs the step once
more: its forward, at the initial context and every design observed, is
the posterior, as the rollout's final forward is; the experiment ends
there.  Every tensor keeps its shape at every trial (the context index
buffer of ``init_ctx_idx``, of capacity n_ctx0 + T, as the rollout's), and
the step changes only values.

**On the card** a trial is one replay of one CUDA graph of the step.  The
graph's key is ``al_curves.graph_key``'s, tagged ``"live"``; it lives in
the model's graphs of ``utils/graphs.py`` ``inference_graphs``, whose
memory pool the rollouts' graphs share.  The first trial of a key runs the
step eagerly on ``side_stream`` (its result) and captures it; every later
trial, of this experiment or of the next of the key, replays it.  The
graph's static inputs are the session's state: a new experiment of the key
loads its batch into them, so one experiment of a key runs at a time (a
session whose graph another session has taken since is refused).  A trial
makes one host read, the design copied to pinned memory and waited for;
``observe`` makes one host-to-device copy, from pinned memory; nothing
else waits for the card.  Graph and eager sessions launch the same kernels
in the same order: the same bits.  Fed the outcomes a pool already holds,
a session gives the designs and the final posterior of
``al_rollout_curves(strategy="aline")``, bit for bit.  CPU tensors run the
steps eagerly.

**Tracing** (``utils/metrics.py``): the span ``live.trial`` covers a
``propose`` from its call until the design is on the host, ``live.observe``
an ``observe``.  The counters ``live.trials`` (one a proposal),
``live.graph_captures`` and ``live.graph_replays`` (every replay, the
posterior's too) go to the innermost open span; what a capture's Python
counts is kept apart and added by each replay (``counted_apart``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from aline_tpu_torch.eval.al_curves import (
    fixed_by_batch,
    graph_key,
    rollout_step,
    weights_of,
)
from aline_tpu_torch.models.heads import GMMParams
from aline_tpu_torch.tasks.base import Batch, init_ctx_idx
from aline_tpu_torch.utils.graphs import (
    Captured,
    Static,
    inference_graphs,
    side_stream,
    tensor_inputs,
)
from aline_tpu_torch.utils.metrics import count, span


class LivePosterior(NamedTuple):
    """The posterior after the designs observed: ``gmm`` over every
    target [B, n_target, C] (``al_curves.posterior_curves`` reads it),
    ``target_weights`` [n_target], and the context the final forward read,
    in acquisition order: ``idx`` [B, n], its designs ``x`` [B, n, dim_x]
    and outcomes ``y`` [B, n, dim_y]."""
    gmm: GMMParams
    target_weights: torch.Tensor
    idx: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor


_FIELDS = frozenset(f.name for f in dataclasses.fields(Batch))


class _TrialGraph(Captured):
    """A key's trial step as a CUDA graph; its static inputs are the state
    of one session at a time, ``owner``."""
    owner: Optional["LiveExperiment"] = None


def _policy(out, b):
    return out.design_out.idx


@torch.no_grad()
def _trial(model, st, batch: Batch, T: int, time_token: bool, sel_targets):
    """One trial on the state ``st`` (updated in place): the last response
    written at the last design, the rollout's step, the design's index
    and value [B, 1 + dim_x] (float64) and the forward's posterior."""
    b = batch.replace(**{n: t for n, t in st.items() if n in _FIELDS})
    dy = b.y.shape[-1]
    st["y"].scatter_(1, st["last"][:, None, None].expand(-1, 1, dy),
                     st["response"][:, None, :])
    if time_token:
        # step k's token (T - k)/T; the posterior keeps the last step's
        b = b.replace(t=(T - torch.clamp(st["step"], max=T - 1)) / T)
        st["step"].add_(1)
    out, idx, nb = rollout_step(model, b, sel_targets, _policy)
    st["ctx_mask"].copy_(nb.ctx_mask)
    st["ctx_idx"].copy_(nb.ctx_idx)
    st["last"].copy_(idx)
    rows = torch.arange(b.batch_size, device=idx.device)
    shown = torch.cat([idx[:, None].to(torch.float64),
                       b.x[rows, idx].to(torch.float64)], dim=1)
    po = out.posterior_out
    return {"shown": shown, "means": po.mixture_means,
            "stds": po.mixture_stds, "weights": po.mixture_weights}


class LiveExperiment:
    """One live experiment of ``model`` over the candidates of ``batch``,
    T trials (the module's docstring).  ``target_weights``: [n_target]
    weights of the posterior's curves, by default the target mask
    normalised; ``time_token``: the eval direction of the time token, as
    ``al_rollout_curves``; ``strategy``: the policy's own choice, the one
    a live session offers (``random`` and ``uncertainty`` are refused)."""

    def __init__(self, model, batch: Batch, T: int,
                 target_weights: Optional[torch.Tensor] = None,
                 time_token: bool = False, strategy: str = "aline"):
        if strategy != "aline":
            raise ValueError(f"a live experiment proposes by the policy "
                             f"(strategy 'aline'), not {strategy!r}")
        sel_targets, n_ctx0 = fixed_by_batch(batch)
        if not 1 <= T <= batch.n_points - n_ctx0:
            raise ValueError(f"T={T} trials over {batch.n_points - n_ctx0} "
                             f"candidates")
        self.T, self.n_ctx0 = T, n_ctx0
        self._args = (T, time_token, sel_targets)
        self._model = model
        b = init_ctx_idx(batch, n_ctx0 + T)
        self.target_weights = weights_of(b, target_weights)
        y = b.y.masked_fill(~b.ctx_mask[..., None], 0)
        last = max(n_ctx0 - 1, 0)       # the first trial's write: a no-op
        extra = dict(last=torch.full((b.batch_size,), last,
                                     dtype=torch.int64, device=b.x.device),
                     response=y[:, last].clone())
        if time_token:
            extra["step"] = torch.zeros((), device=b.x.device)
        self._batch = b.replace(y=y)
        state = tensor_inputs(self._batch, **extra)
        self._cuda = b.x.is_cuda
        self._capture = None
        if self._cuda:
            self._key = ("live", *graph_key(model, batch, target_weights,
                                            T, strategy, time_token,
                                            sel_targets, n_ctx0))
            graphs = inference_graphs.of(model)
            g = graphs.graphs.get(self._key)
            if g is None:
                g = _TrialGraph(state)
                self._capture = graphs
            else:
                g.load(state)
            g.owner = self
            self._g = g
            self._st = g.inputs
            self._shown = torch.empty(
                (b.batch_size, 1 + b.x.shape[-1]), dtype=torch.float64,
                pin_memory=True)
            self._resp = torch.empty(extra["response"].shape, pin_memory=True,
                                     dtype=y.dtype)
            self._read = torch.cuda.Event()
        else:
            self._st = Static(state).inputs
        self._t = 0
        self._pending = False
        self._ended = False

    # -- the caller's side -------------------------------------------------
    def propose(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The next design: its index among the candidates [B] (int64) and
        its value [B, dim_x], on the host."""
        self._check("propose")
        if self._pending:
            raise RuntimeError("propose() before observe() of the design "
                               "proposed last")
        if self._t >= self.T:
            raise RuntimeError(f"a trial past T={self.T}")
        with span("live.trial"):
            count("live.trials", 1)
            shown = self._to_host(self._step()["shown"])
        self._pending = True
        return shown[:, 0].to(torch.int64), \
            shown[:, 1:].to(self._batch.x.dtype)

    def observe(self, response) -> None:
        """The subject's response to the design proposed last: a number
        for each row, [B] or [B, dim_y]."""
        self._check("observe")
        if not self._pending:
            raise RuntimeError("observe() before propose(): no design "
                               "waits for a response")
        with span("live.observe"):
            dst = self._st["response"]
            r = torch.as_tensor(response, dtype=dst.dtype).reshape(dst.shape)
            if self._cuda:
                self._resp.copy_(r)
                dst.copy_(self._resp, non_blocking=True)
            else:
                dst.copy_(r)
        self._pending = False
        self._t += 1

    def posterior(self) -> LivePosterior:
        """The posterior after the designs observed so far; it ends the
        experiment."""
        self._check("posterior")
        if self._pending:
            raise RuntimeError("posterior() while a design waits for its "
                               "response")
        n = self.n_ctx0 + self._t
        ctx = self._st["ctx_idx"][:, :n].clone()   # what the forward reads
        out = self._step()
        self._ended = True
        rows = torch.arange(ctx.shape[0], device=ctx.device)[:, None]
        return LivePosterior(
            gmm=GMMParams(out["means"].clone(), out["stds"].clone(),
                          out["weights"].clone()),
            target_weights=self.target_weights, idx=ctx,
            x=self._st["x"][rows, ctx], y=self._st["y"][rows, ctx])

    # -- the step ----------------------------------------------------------
    def _check(self, call: str) -> None:
        if self._ended:
            raise RuntimeError(f"{call}() after posterior(): the experiment "
                               f"has ended")
        if self._cuda and self._g.owner is not self:
            raise RuntimeError(f"{call}(): another experiment of the same "
                               f"key has taken this one's graph since; run "
                               f"one at a time")

    def _run(self, st):
        return _trial(self._model, st, self._batch, *self._args)

    def _step(self):
        if not self._cuda:
            return self._run(self._st)
        g = self._g
        if self._capture is not None:
            graphs, self._capture = self._capture, None
            first = g.capture(self._run, side_stream(self._batch.x.device),
                              graphs.handle)
            graphs.graphs[self._key] = g
            count("live.graph_captures", 1)
            return first
        g.replay()
        count("live.graph_replays", 1)
        return g.outputs

    def _to_host(self, shown: torch.Tensor) -> torch.Tensor:
        if not self._cuda:
            return shown.clone()
        self._shown.copy_(shown, non_blocking=True)
        self._read.record()
        self._read.synchronize()
        return self._shown.clone()
