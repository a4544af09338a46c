"""The trainer's rollout through CUDA graphs (``aline_tpu_torch/train/
graph.py``, ``loop.rollout``) on the CPU, at a tiny configuration.

* A CPU trainer never captures or replays (``train.graph_captures`` and
  ``train.graph_replays`` stay 0 with tracing on), and its epochs are bit
  for bit those of the trainer with ``train/rollout.py``'s ``rollout`` in
  ``loop.rollout``, in both variants of the split mask, under the compact
  and the flash attention and under ``remat_policy=dots``.
* ``graph_key`` separates what a captured rollout depends on besides its
  inputs' values (the phase, by the pool's size; T; ``sel_targets``;
  shapes; the parameters' addresses; ...) and is the same for new values
  of the same form; under flash one key serves both masks.
* ``loop.rollout`` is called once an epoch, and its ``idx`` is that
  epoch's designs.
* With the capture stubbed (``torch.cuda.graph`` a plain block, a graph's
  replay a no-op), the counters a capture records are added once per
  replay: the forward's under ``train.rollout``, the backward's under
  ``train.backward``, and the eager epoch's counts are not doubled; a
  backward after another key's replay is refused.

The graphs themselves run on the card: tests/test_torch_cuda.py.
"""
import contextlib
import logging

import pytest
import torch

from aline_tpu_torch import config as tcfg
from aline_tpu_torch.ops import _build
from aline_tpu_torch.train import graph, loop
from aline_tpu_torch.train import rollout as eager
from aline_tpu_torch.train.loop import Trainer
from aline_tpu_torch.utils import metrics
from aline_tpu_torch.utils.graphs import counted_apart

torch.set_num_threads(1)
SMALL = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
         "task.n_context_init=1", "task.n_query_init=8",
         "task.n_target_data=4", "encoder.dim_embedding=16",
         "encoder.dim_feedforward=32", "encoder.n_head=2",
         "encoder.num_layers=2", "head.num_components=4", "batch_size=4",
         "min_T=4", "T=4", "max_epoch=10", "burning_epoch=0",
         "checkpoint=0", "verbose=100"]
T = 4
LAYERS = 2
FLASH = ("encoder.attention_impl=flash",)
COUNTERS = ("flash.plan", "flash.fwd", "flash.bwd")


@pytest.fixture(autouse=True)
def clean_state():
    metrics.set_tracing(False)
    metrics.collect()
    yield
    metrics.set_tracing(False)
    metrics.collect()
    graph._pools.clear()


def _trainer(tmp_path, *extra):
    tc = tcfg.parse_overrides(SMALL + list(extra)
                              + [f"output_dir={tmp_path}"])
    return Trainer(tc, logger=logging.getLogger("test_train_graph"),
                   device="cpu")


def _spied(monkeypatch):
    """``loop.rollout`` wrapped: the list of its calls' arguments, results
    and the eager steps' result on the same inputs and
    parameters (before the epoch's update)."""
    calls = []
    orig = loop.rollout

    def spy(model, batch, T, w_query, w_pred, gumbel, **kw):
        args = (model, batch, T, w_query, w_pred, gumbel)
        ro = orig(*args, **kw)
        with torch.no_grad():
            want = eager.rollout(*args, **kw)
        calls.append((args, kw, ro, want))
        return ro

    monkeypatch.setattr(loop, "rollout", spy)
    return calls


def _key(call):
    args, kw = call[:2]
    return graph.graph_key(*args, **kw)


def _counts(spans, name):
    return sum(s.counts.get(name, 0) for s in spans)


@pytest.mark.parametrize("extra", [(), FLASH])
def test_cpu_trainer_never_captures(tmp_path, extra):
    tr = _trainer(tmp_path, *extra)
    metrics.set_tracing(True)
    for epoch in range(3):
        tr.train_epoch(epoch)
    spans = metrics.collect()
    assert _counts(spans, "train.graph_captures") == 0
    assert _counts(spans, "train.graph_replays") == 0
    assert tr.model not in graph._pools


@pytest.mark.parametrize("attend_to", ["data", "theta"])
@pytest.mark.parametrize("extra", [(), FLASH, ("remat_policy=dots",)])
def test_cpu_trainer_equals_the_eager_loop_bitwise(tmp_path, monkeypatch,
                                                   attend_to, extra):
    args = (f"task.attend_to={attend_to}", *extra)
    got_tr = _trainer(tmp_path / "graph", *args)
    got = [got_tr.train_epoch(e) for e in range(3)]
    monkeypatch.setattr(loop, "rollout", eager.rollout)
    want_tr = _trainer(tmp_path / "eager", *args)
    want = [want_tr.train_epoch(e) for e in range(3)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(torch.as_tensor(g[k]),
                               torch.as_tensor(w[k])), k
    for (n, p), q in zip(got_tr.model.named_parameters(),
                         want_tr.model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(p.grad, q.grad), n


def test_rollout_called_once_an_epoch_with_its_designs(tmp_path,
                                                       monkeypatch):
    tr = _trainer(tmp_path)
    calls = _spied(monkeypatch)
    for epoch in range(3):
        tr.train_epoch(epoch)
    assert len(calls) == 3
    for _, _, ro, want in calls:
        assert torch.equal(ro.idx, want.idx)
        assert torch.equal(ro.final_ctx_mask, want.final_ctx_mask)
    assert not torch.equal(calls[0][2].idx, calls[1][2].idx)


def _changed(what, calls):
    """The key of the base call (a main-phase epoch, data mask: the
    second of ``calls``) with ``what`` changed."""
    (model, batch, T_, w_q, w_p, gumbel), kw = calls[1][:2]
    if what == "phase":
        return _key(calls[0])       # the burning epoch before it
    if what == "sel_targets":
        kw = dict(kw, sel_targets=(4, 5))
    elif what == "T":
        T_ = T - 1
    elif what in ("time_token", "use_remat"):
        kw = dict(kw, **{what: not kw[what]})
    elif what == "remat_policy":
        kw = dict(kw, remat_policy="dots")
    elif what == "batch_size":
        batch = batch.replace(**{f: getattr(batch, f)[:2] for f in
                                 ("x", "y", "ctx_mask", "target_x",
                                  "target_all", "theta", "ctx_idx")})
        gumbel = gumbel[:, :2]
    elif what == "pool_size":
        batch = batch.replace(x=batch.x[:, :-1])
    elif what == "dtype":
        batch = batch.replace(y=batch.y.double())
    elif what == "ctx_capacity":
        batch = batch.replace(ctx_capacity=batch.ctx_capacity + 1)
    elif what == "gumbel":
        gumbel = gumbel[:-1]
    elif what == "weights":
        w_q = w_q.double()
    elif what == "parameter":
        p = model.encoder.layer_0.linear1.weight
        p.data = p.data.clone()
    else:
        raise AssertionError(what)
    return graph.graph_key(model, batch, T_, w_q, w_p, gumbel, **kw)


@pytest.mark.parametrize("what", [
    "phase", "sel_targets", "T", "time_token", "use_remat", "remat_policy",
    "batch_size", "pool_size", "dtype", "ctx_capacity", "gumbel", "weights",
    "parameter"])
def test_graph_key_separates(tmp_path, monkeypatch, what):
    tr = _trainer(tmp_path, "task.attend_to=data", "burning_epoch=1")
    calls = _spied(monkeypatch)
    tr.train_epoch(0)
    tr.train_epoch(1)
    base = _key(calls[1])
    assert _changed(what, calls) != base


@pytest.mark.parametrize("extra,keys", [((), 2), (FLASH, 1)])
def test_graph_key_same_for_new_values_of_the_same_form(tmp_path,
                                                        monkeypatch, extra,
                                                        keys):
    """New batches, noise and (flash) masks keep the key; the compact
    core keys the split mask's two variants apart by ``sel_targets``."""
    tr = _trainer(tmp_path, *extra)
    calls = _spied(monkeypatch)
    for epoch in range(8):
        tr.train_epoch(epoch)
    masks = {tuple(c[0][1].target_mask.tolist()) for c in calls}
    assert len(masks) == 2
    assert len({_key(c) for c in calls}) == keys
    # weights loaded in place keep the addresses the graphs read
    before = _key(calls[0])
    tr.model.load_state_dict({k: v + 1
                              for k, v in tr.model.state_dict().items()})
    assert _key(calls[0]) == before


def test_counted_apart_keeps_the_block_apart():
    metrics.set_tracing(True)
    entry = "flash_plan"
    launches = _build.LAUNCHES[entry]
    with metrics.span("outer"):
        with counted_apart() as rec:
            _build.LAUNCHES[entry] += 2
            metrics.count("flash.fwd", 3)
        assert _build.LAUNCHES[entry] == launches
        assert rec.launches == {entry: 2}
        assert rec.counts == {"flash.fwd": 3}
        rec.add()
        rec.add()
    assert _build.LAUNCHES[entry] == launches + 4
    _build.LAUNCHES[entry] = launches
    (outer,) = metrics.collect()
    assert outer.counts == {"flash.fwd": 6}


class _StubGraph:
    """A CUDA graph that records nothing and replays nothing."""

    def replay(self):
        pass


@pytest.fixture
def stubbed(monkeypatch):
    """The graph path on the CPU with the capture stubbed: the captured
    block runs as a plain block, and a replay runs nothing."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(graph, "side_stream", lambda device: None)
    monkeypatch.setattr(graph, "engages", lambda batch, gumbel: (
        gumbel is not None and torch.is_grad_enabled()))


def _under(spans, name):
    """The counters summed over the spans named ``name``."""
    picked = [s for s in spans if s.name == name]
    return {c: _counts(picked, c) for c in COUNTERS}


def test_replay_adds_the_capture_counts_under_their_spans(tmp_path,
                                                          stubbed):
    tr = _trainer(tmp_path, "task.attend_to=data", *FLASH)
    metrics.set_tracing(True)
    epochs = []
    for epoch in range(3):          # eager; the capture and a replay; a replay
        tr.train_epoch(epoch)
        epochs.append(metrics.collect())
    assert [(_counts(e, "train.graph_captures"),
             _counts(e, "train.graph_replays")) for e in epochs] \
        == [(0, 0), (1, 1), (0, 1)]
    # the eager epoch: plan and forwards in the rollout and again in the
    # backward's recompute; a replayed epoch the same, the capture's own
    # counts not among them
    want = {"flash.plan": 2 * T, "flash.fwd": 2 * LAYERS * T,
            "flash.bwd": LAYERS * T}
    for e in epochs:
        assert {c: _counts(e, c) for c in COUNTERS} == want
    for e in epochs[1:]:
        assert _under(e, "train.rollout") == {
            "flash.plan": T, "flash.fwd": LAYERS * T, "flash.bwd": 0}
        assert _under(e, "train.backward") == {
            "flash.plan": T, "flash.fwd": LAYERS * T,
            "flash.bwd": LAYERS * T}
    # a replay runs no Python of the steps (the stub's capture does)
    assert not [s for s in epochs[2] if s.name == "model.forward"]
    (g,) = graph._pools[tr.model].graphs.values()
    assert g.fwd_counted.counts == {"flash.plan": T,
                                    "flash.fwd": LAYERS * T}
    assert g.bwd_counted.counts == {"flash.plan": T, "flash.fwd": LAYERS * T,
                                    "flash.bwd": LAYERS * T}


def test_backward_after_another_replay_is_refused(tmp_path, monkeypatch,
                                                  stubbed):
    tr = _trainer(tmp_path, "task.attend_to=data")
    calls = _spied(monkeypatch)
    tr.train_epoch(0)
    args, kw = calls[0][:2]
    shorter = (*args[:2], T - 1, *args[3:5], args[5][:T - 1])
    graph.rollout(*shorter, **kw)                # a second key, eagerly
    graph.rollout(*shorter, **kw).nll_pred.sum().backward()   # its capture
    graph.rollout(*args, **kw).nll_pred.sum().backward()      # the first's
    first = graph.rollout(*args, **kw)
    second = graph.rollout(*shorter, **kw)
    with pytest.raises(RuntimeError, match="another rollout"):
        first.nll_pred.sum().backward()
    second.nll_pred.sum().backward()
    again = graph.rollout(*args, **kw)
    again.nll_pred.sum().backward()
    assert len(graph._pools[tr.model].graphs) == 2
