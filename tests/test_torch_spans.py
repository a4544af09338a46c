"""The port's tracer (``aline_tpu_torch/utils/metrics.py``) on the CPU, at a
tiny configuration.

* Off (the default), a span is the shared null context: no ``Span``, no
  CUDA event, no ``record_function``; the program's outputs are the same
  bit for bit with tracing on and off.
* On, the spans form the tree of the program's layers: an epoch holds its
  sample and step phases, the step its rollout, loss, backward and
  optimizer, with the T checkpointed steps once under the rollout and once
  under the backward; an AL rollout holds T + 1 forwards; a fold holds one
  chunk span per chunk.
* A span begun on a thread with no span open (autograd's device thread)
  takes the span open on another thread as its parent; while a CUDA graph
  is captured, spans do nothing.
"""
import math
import threading

import pytest
import torch

from aline_tpu_torch import config as tcfg
from aline_tpu_torch.eval.al_curves import al_rollout_curves
from aline_tpu_torch.eval.eig import compute_eig_from_history
from aline_tpu_torch.eval.traces import get_traces
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.ces import CESTask
from aline_tpu_torch.tasks.location_finding import HiddenLocation
from aline_tpu_torch.train.loop import Trainer
from aline_tpu_torch.utils import metrics

torch.set_num_threads(1)
SMALL = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
         "task.n_context_init=1", "task.n_query_init=8",
         "task.n_target_data=4", "encoder.dim_embedding=16",
         "encoder.dim_feedforward=32", "encoder.n_head=2",
         "encoder.num_layers=2", "head.num_components=4", "batch_size=4",
         "min_T=4", "T=4", "max_epoch=6", "burning_epoch=0",
         "checkpoint=0", "verbose=100"]
T = 4
L, L_CHUNK = 1000, 300


@pytest.fixture(autouse=True)
def tracing_reset():
    metrics.set_tracing(False)
    metrics.collect()
    yield
    metrics.set_tracing(False)
    metrics.collect()


def _cfg(tmp, *extra):
    return tcfg.parse_overrides(SMALL + list(extra) + [f"output_dir={tmp}"])


def _trainer(tmp, *extra):
    tr = Trainer(_cfg(tmp, *extra), device="cpu")
    tr._ensure_phase("main")
    return tr


def _model_and_batch(tmp):
    cfg = _cfg(tmp)
    torch.manual_seed(0)
    model = build_model(cfg, "cpu").eval()
    task = build_task(cfg.task)
    batch = task.sample_batch(torch.Generator().manual_seed(1), 3,
                              cfg.task.n_query_init)
    return model, task, batch


def _history():
    tt = HiddenLocation(tcfg.parse_overrides(
        ["task=location_finding"]).task)
    g = torch.Generator().manual_seed(2)
    theta_0 = tt.sample_theta(g, (5,))
    x = torch.rand(5, 6, 2, generator=g)
    signal = tt.total_density(x, theta_0[:, None])
    y = signal + 0.5 * torch.randn(signal.shape, generator=g)
    return tt, theta_0, x, y


def _ces_history(tail_mode="log_ndtr"):
    tt = build_task(tcfg.parse_overrides(
        ["task=ces", f"task.tail_mode={tail_mode}"]).task)
    assert isinstance(tt, CESTask)
    g = torch.Generator().manual_seed(3)
    theta_0 = tt.sample_theta(g, (5,))
    x = 100.0 * torch.rand(5, 6, 6, generator=g)
    y = tt.simulate(g, x, theta_0[:, None])
    return tt, theta_0, x, y


def _run(case, tmp):
    """The case's outputs: an epoch's metrics and parameters, an AL
    rollout's curves, or the bounds of a fold."""
    if case == "train":
        tr = _trainer(tmp)
        m = tr.train_epoch(0)
        return list(m.values()) + [p.detach().clone()
                                   for p in tr.model.parameters()]
    if case == "al":
        model, _, batch = _model_and_batch(tmp)
        return list(al_rollout_curves(model, batch, T).values())
    tt, theta_0, x, y = _ces_history() if case == "ces" else _history()
    return list(compute_eig_from_history(tt, theta_0, x, y, L, 7,
                                         L_chunk=L_CHUNK, stepwise=True))


def _tree(spans):
    """{id: span} and {parent id: [child names in order of start]}."""
    by_id = {s.id: s for s in spans}
    kids = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        kids.setdefault(s.parent, []).append(s.name)
    return by_id, kids


def _only(spans, name):
    found = [s for s in spans if s.name == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


# -- off --------------------------------------------------------------------

@pytest.mark.parametrize("case", ["train", "al", "eig", "ces"])
def test_spans_off_create_no_event_and_no_annotation(case, tmp_path,
                                                     monkeypatch):
    made = []

    def count(kind):
        def make(*a, **kw):
            made.append(kind)
            raise AssertionError(f"a {kind} was made with tracing off")
        return make

    monkeypatch.setattr(torch.cuda, "Event", count("CUDA event"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        count("record_function"))
    monkeypatch.setattr(metrics, "Span", count("Span"))
    assert metrics.span("a") is metrics.span("b")
    _run(case, tmp_path)
    assert made == [] and metrics.collect() == []


@pytest.mark.parametrize("case", ["train", "al", "eig", "ces"])
def test_outputs_bit_identical_with_tracing_on_and_off(case, tmp_path):
    off = _run(case, tmp_path / "off")
    metrics.set_tracing(True)
    on = _run(case, tmp_path / "on")
    assert metrics.collect()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# -- on: the span tree ------------------------------------------------------

@pytest.mark.parametrize("policy", ["full", "dots"])
def test_train_epoch_span_tree(policy, tmp_path):
    tr = _trainer(tmp_path, f"remat_policy={policy}")
    metrics.set_tracing(True)
    tr.train_epoch(0)
    spans = metrics.collect()
    by_id, kids = _tree(spans)
    epoch = _only(spans, "train.epoch")
    assert epoch.parent is None and kids[None] == ["train.epoch"]
    assert kids[epoch.id] == ["train.sample", "train.step"]
    step = _only(spans, "train.step")
    assert kids[step.id] == ["train.rollout", "train.loss",
                             "train.backward", "train.optimizer"]
    # the T checkpointed steps, then their recomputation in the backward
    assert kids[_only(spans, "train.rollout").id] == ["rollout.step"] * T
    assert kids[_only(spans, "train.backward").id] == ["rollout.step"] * T
    for s in spans:
        if s.name == "rollout.step":
            assert kids[s.id] == ["model.forward"]
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
        assert s.stream_s() is None        # no card: host times alone
    assert tr.timer.count("sample") == tr.timer.count("step") == 1
    assert tr.timer.stream_summary() == ""


def test_al_rollout_span_tree(tmp_path):
    model, _, batch = _model_and_batch(tmp_path)
    metrics.set_tracing(True)
    al_rollout_curves(model, batch, T)
    spans = metrics.collect()
    _, kids = _tree(spans)
    top = _only(spans, "al.rollout")
    assert kids[None] == ["al.rollout"]
    assert kids[top.id] == (["model.forward", "al.choose", "al.select"] * T
                            + ["model.forward", "al.choose"])


def test_bed_traces_and_fold_span_trees(tmp_path):
    model, task, batch = _model_and_batch(tmp_path)
    metrics.set_tracing(True)
    get_traces(model, task, batch, T)
    tt, theta_0, x, y = _history()
    compute_eig_from_history(tt, theta_0, x, y, L, 7, L_chunk=L_CHUNK)
    spans = metrics.collect()
    _, kids = _tree(spans)
    assert kids[None] == ["bed.traces", "eig.fold"]
    traces = _only(spans, "bed.traces")
    assert kids[traces.id] == ["rollout.step"] * T
    fold = _only(spans, "eig.fold")
    assert kids[fold.id] == ["eig.chunk"] * math.ceil(L / L_CHUNK)


def test_generic_fold_chunks_hold_loglik_and_lse():
    """The generic fold (CES with the reference's tails; with log_ndtr
    tails CES has its own fold, whose chunks hold no inner span)."""
    tt, theta_0, x, y = _ces_history("reference")
    metrics.set_tracing(True)
    compute_eig_from_history(tt, theta_0, x, y, L, 7, L_chunk=L_CHUNK)
    spans = metrics.collect()
    by_id, kids = _tree(spans)
    fold = _only(spans, "eig.fold")
    chunks = [s for s in spans if s.name == "eig.chunk"]
    assert kids[fold.id] == ["eig.chunk"] * math.ceil(L / L_CHUNK)
    for c in chunks:
        assert kids[c.id] == ["eig.loglik", "eig.lse"]
    for s in spans:
        if s.name in ("eig.loglik", "eig.lse"):
            up = by_id[s.parent]
            assert up.name == "eig.chunk"
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns


@pytest.mark.parametrize("tail_mode", ["log_ndtr", "reference"])
def test_ces_chunks_hold_inner_spans_on_the_generic_fold_only(tail_mode):
    """CES with log_ndtr tails folds each chunk through ``ces_eig_fold``
    (one kernel a chunk on the card): its chunk spans hold no
    ``eig.loglik`` or ``eig.lse``; with the reference's tails the generic
    fold's two."""
    tt, theta_0, x, y = _ces_history(tail_mode)
    metrics.set_tracing(True)
    compute_eig_from_history(tt, theta_0, x, y, L, 7, L_chunk=L_CHUNK)
    spans = metrics.collect()
    _, kids = _tree(spans)
    chunks = [s for s in spans if s.name == "eig.chunk"]
    assert len(chunks) == math.ceil(L / L_CHUNK)
    want = [] if tail_mode == "log_ndtr" else ["eig.loglik", "eig.lse"]
    assert all(kids.get(c.id, []) == want for c in chunks)


@pytest.mark.parametrize("case", ["ces", "eig"])
def test_eig_terms_count_every_folded_term(case):
    tt, theta_0, x, y = _ces_history() if case == "ces" else _history()
    metrics.set_tracing(True)
    compute_eig_from_history(tt, theta_0, x, y, L, 7, L_chunk=L_CHUNK)
    spans = metrics.collect()
    chunks = [s for s in spans if s.name == "eig.chunk"]
    B, Th = x.shape[:2]
    assert L % L_CHUNK and len(chunks) == math.ceil(L / L_CHUNK)
    assert [c.counts["eig.terms"] for c in chunks] == (
        [L_CHUNK * B * Th] * (len(chunks) - 1) + [(L % L_CHUNK) * B * Th])
    assert sum(c.counts["eig.terms"] for c in chunks) == L * B * Th
    # counted where the work is: no other span holds the counter
    assert all(not s.counts for s in spans if s.name != "eig.chunk")


def test_count_adds_to_the_innermost_span_and_nothing_when_off():
    metrics.count("n", 5)                  # off: no span, nothing to do
    metrics.set_tracing(True)
    metrics.count("n", 5)                  # on, no span open: dropped
    with metrics.span("outer") as outer:
        metrics.count("n", 2)
        with metrics.span("inner") as inner:
            metrics.count("n", 3)
            metrics.count("n", 4)
            metrics.set_tracing(False)
            metrics.count("n", 100)        # off again: not recorded
            metrics.set_tracing(True)
    assert outer.counts == {"n": 2} and inner.counts == {"n": 7}
    assert [s.name for s in metrics.collect()] == ["inner", "outer"]


# -- on: threads, capture, phases, collect ----------------------------------

def test_a_span_on_another_thread_takes_the_open_span_as_parent():
    metrics.set_tracing(True)
    seen = []

    def worker():
        with metrics.span("inner") as s:
            seen.append(s)

    with metrics.span("outer") as outer:
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    assert seen[0].parent == outer.id
    with metrics.span("after") as after:
        pass
    assert after.parent is None
    assert [s.name for s in metrics.collect()] == ["inner", "outer", "after"]
    assert metrics.collect() == []


def test_spans_do_nothing_while_a_graph_is_captured(monkeypatch):
    metrics.set_tracing(True)
    monkeypatch.setattr(metrics, "_events", True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with metrics.span("captured") as s:
        assert s is None
    assert metrics.collect() == []


def test_phase_is_one_span_named_with_the_prefix():
    timer = metrics.PhaseTimer(span_prefix="train.")
    metrics.set_tracing(True)
    with timer.phase("sample"):
        with metrics.span("inside"):
            pass
    spans = metrics.collect()
    outer = _only(spans, "train.sample")
    assert _only(spans, "inside").parent == outer.id
    assert timer.count("sample") == 1 and timer.total("sample") > 0
    assert outer.start_ns <= outer.end_ns
