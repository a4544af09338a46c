"""The trainer's rollout (``loop.rollout``): on the card, its forward and
its backward as CUDA graphs, captured once per key and replayed every
epoch; elsewhere ``train/rollout.py``'s ``rollout`` as it is.

**Where it engages.**  A training rollout (Gumbel noise given, autograd
recording) on CUDA tensors, outside anomaly mode and the NaN guard
(``debug_nans``): ``engages``.  The CPU, the greedy rollouts of
``eval/traces.py`` (which call ``train/rollout.py`` directly) and
``debug_nans`` run the steps eagerly.

**Key** (``graph_key``): what the captured work depends on besides the
values of its inputs: T, the compact attention's ``sel_targets``, the
time token, ``use_remat`` and ``remat_policy``; the shape, dtype and
device of every tensor field of the batch, of the noise and of the two
weight vectors, and the batch's integer fields; the addresses of the
model's parameters and buffers.  The phase reaches the rollout only
through the pool's size (burning shrinks it to T), which the shapes
hold.  The target mask is a tensor the steps read: where ``sel_targets``
is None (flash, naive) one key serves every mask.

**Capture.**  A key's first call runs the steps eagerly on the caller's
stream; that is the call's result, and its backward is autograd's as
before.  The key's next call captures, from static copies of its inputs,
on a side stream, the forward (``train/rollout.py``'s steps under the
configuration's remat, each step's inputs saved for the backward) and
the backward: ``torch.autograd.grad`` of the three float outputs
(``DIFFERENTIABLE``) with respect to the parameters, from static
gradient buffers, which recomputes each step (the pattern of
``torch.cuda.make_graphed_callables``); then it replays them as below.
No extra warm-up: the eager epoch has built the kernels, the optimizer's
state and the libraries' handles, those of autograd's device thread
included, which runs the backward and cannot make a cuBLAS handle while
a capture runs (so the capture waits for the key's eager backward).

**Replay.**  Every later call copies the batch, the noise and the
weights into the static inputs and replays the forward inside
``_Replayed``, a ``torch.autograd.Function`` over the parameters, which
returns clones of the static outputs; its backward copies the incoming gradients into the
static buffers, replays the backward graph and returns clones of the
gradients.  An output the loss does not differentiate (``nll_query``)
gets a zero gradient, which adds exact zeros.  The loss, the backward
call, the data axis's all-reduce, the clip and AdamW run eagerly, as
before.  Graph and eager steps launch the same kernels on the same
inputs.

**Memory.**  The graphs of one model share one pool, held with the graphs
for one model at a time (a capture for another model drops them).  What
a key's forward saves for its backward lives in that pool until the
backward replays; another key's graphs may reuse that memory, so the
backward of a replay is refused once any other forward of the pool has
replayed since (the trainer runs forward, backward, forward, ...).  A
replay's outputs and gradients are cloned before the next replay.

**Counters.**  Each replay adds what its capture's Python counted
(``utils/graphs.py`` ``counted_apart``): the kernel launches and the
``flash.*`` counts, the forward's in the span open around the call
(``train.rollout``), the backward's in the one open around ``backward``
(``train.backward``).  ``train.graph_captures`` and
``train.graph_replays`` count the calls that captured and that replayed
(a capturing call does both).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.autograd.function import once_differentiable

from aline_tpu_torch.tasks.base import Batch
from aline_tpu_torch.train import rollout as eager
from aline_tpu_torch.train.rollout import RolloutOutputs
from aline_tpu_torch.utils.debug import guard_active
from aline_tpu_torch.utils.graphs import (
    Counted,
    GraphCache,
    Graphs,
    Static,
    addresses,
    batch_form,
    counted_apart,
    form,
    side_stream,
    tensor_inputs,
)
from aline_tpu_torch.utils.metrics import count

# the outputs that carry the parameters' gradients
DIFFERENTIABLE = ("log_probs", "nll_query", "nll_pred")


def engages(batch: Batch, gumbel: Optional[torch.Tensor]) -> bool:
    """Whether a rollout takes the graph path (module docstring)."""
    return (gumbel is not None and batch.x.is_cuda
            and torch.is_grad_enabled() and not torch.is_anomaly_enabled()
            and not guard_active())


def graph_key(model, batch: Batch, T: int, w_query, w_pred, gumbel, *,
              time_token: bool, use_remat: bool, remat_policy: str,
              sel_targets: Optional[tuple]) -> tuple:
    """What a captured rollout of ``model`` depends on besides the values
    of its inputs (module docstring)."""
    return (T, sel_targets, time_token, use_remat, remat_policy,
            batch_form(batch), form(gumbel), form(w_query), form(w_pred),
            addresses(model))


class _Pool(Graphs):
    """One model's graphs ({key: _TrainGraph}) and their memory pool
    (``utils/graphs.py`` ``Graphs``), the keys seen once (run eagerly), and
    the number of forwards replayed from the pool (``turn``)."""

    def __init__(self):
        super().__init__()
        self.seen: set = set()
        self.turn = 0


class _TrainGraph(Static):
    """One key's rollout as a forward and a backward CUDA graph: static
    inputs (``utils/graphs.py`` ``Static``), outputs, gradient buffers and
    gradients, and what each graph's capture counted."""

    def __init__(self, inputs: Dict[str, torch.Tensor], params: tuple):
        super().__init__(inputs)
        self.params = params
        self.fwd = torch.cuda.CUDAGraph()
        self.bwd = torch.cuda.CUDAGraph()
        self.fwd_counted = self.bwd_counted = Counted()

    def capture(self, run, stream, pool) -> None:
        """Capture ``run(static inputs)`` and the gradients of its
        ``DIFFERENTIABLE`` outputs with respect to ``params`` on
        ``stream``, into ``pool``."""
        with counted_apart() as self.fwd_counted, \
                torch.cuda.graph(self.fwd, pool=pool, stream=stream):
            out = run(self.inputs)
        diff = [getattr(out, n) for n in DIFFERENTIABLE]
        self.grad_outputs = [torch.zeros_like(t) for t in diff]
        with counted_apart() as self.bwd_counted, \
                torch.cuda.graph(self.bwd, pool=pool, stream=stream):
            self.grads = torch.autograd.grad(diff, self.params,
                                             self.grad_outputs,
                                             allow_unused=True)
        self.outputs = out._replace(**{n: t.detach()
                                       for n, t in zip(DIFFERENTIABLE, diff)})

    def replay(self, inputs: Dict[str, torch.Tensor],
               pool: _Pool) -> RolloutOutputs:
        self.load(inputs)
        diff = _Replayed.apply(self, pool, *self.params)
        return self.outputs._replace(
            **dict(zip(DIFFERENTIABLE, diff)),
            **{n: getattr(self.outputs, n).clone()
               for n in RolloutOutputs._fields if n not in DIFFERENTIABLE})


class _Replayed(torch.autograd.Function):
    """A replay of a ``_TrainGraph``'s forward as a function of the
    parameters; its backward replays the backward graph."""

    @staticmethod
    def forward(ctx, g: _TrainGraph, pool: _Pool, *params):
        g.fwd.replay()
        g.fwd_counted.add()
        pool.turn += 1
        ctx.g, ctx.pool, ctx.turn = g, pool, pool.turn
        return tuple(getattr(g.outputs, n).clone() for n in DIFFERENTIABLE)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        if ctx.pool.turn != ctx.turn:
            raise RuntimeError("a graphed training rollout's backward after "
                               "another rollout of the same model replayed: "
                               "what it saved is overwritten; call backward "
                               "before the next rollout")
        g = ctx.g
        for static, grad in zip(g.grad_outputs, grads):
            static.copy_(grad)
        g.bwd.replay()
        g.bwd_counted.add()
        return (None, None, *(None if t is None else t.clone()
                              for t in g.grads))


# model → its _Pool, for one model at a time
_pools = GraphCache(_Pool)


def rollout(model, batch: Batch, T: int, w_query: torch.Tensor,
            w_pred: torch.Tensor, gumbel: Optional[torch.Tensor] = None, *,
            time_token: bool = False, use_remat: bool = True,
            remat_policy: str = "full",
            sel_targets: Optional[tuple] = None) -> RolloutOutputs:
    """``train/rollout.py``'s ``rollout`` (training direction of the time
    token), through the graphs of its key where ``engages`` (module
    docstring)."""
    kw = dict(time_token=time_token, use_remat=use_remat,
              remat_policy=remat_policy, sel_targets=sel_targets)
    if not engages(batch, gumbel):
        return eager.rollout(model, batch, T, w_query, w_pred, gumbel, **kw)
    key = graph_key(model, batch, T, w_query, w_pred, gumbel, **kw)
    pool = _pools.of(model)
    inputs = tensor_inputs(batch, gumbel=gumbel, w_query=w_query,
                           w_pred=w_pred)
    g = pool.graphs.get(key)
    if g is None:
        if key not in pool.seen:
            pool.seen.add(key)
            return eager.rollout(model, batch, T, w_query, w_pred, gumbel,
                                 **kw)

        def run(static):
            b = batch.replace(**{n: t for n, t in static.items()
                                 if n not in ("gumbel", "w_query", "w_pred")})
            return eager.rollout(model, b, T, static["w_query"],
                                 static["w_pred"], static["gumbel"], **kw)

        g = _TrainGraph(inputs, tuple(p for p in model.parameters()
                                      if p.requires_grad))
        g.capture(run, side_stream(batch.x.device), pool.handle)
        pool.graphs[key] = g
        count("train.graph_captures", 1)
    count("train.graph_replays", 1)
    return g.replay(inputs, pool)
