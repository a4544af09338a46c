"""The live session (``aline_tpu_torch/eval/live.py``) on the CPU, at tiny
configurations.

* Fed the outcomes a pool already holds, a session's designs and its final
  posterior's curves are ``al_rollout_curves(strategy="aline")``'s bit for
  bit: a tiny GP model under the default, data and theta masks, with and
  without the time token, and a tiny psychometric model under each of its
  three masks.  The outcomes of the candidates outside the initial context
  are NaN, which the session never reads.
* Against the plain reference (``portbench/reference/psych.py``) on seeded
  random weights in float32, the subjects answering by its ``respond``:
  the reference's replay of the session's stimuli and answers reads each
  stimulus its argmax within 1e-4 nats, and the final posterior's
  log-prob and RMSE at the subjects' parameters within 1e-4 of its own
  (the float32 rounding of two orders of summation; measured 0 and 6e-7).
* The refusals: observe before propose, propose twice, a trial past T,
  anything after the posterior, the posterior while a design waits, more
  trials than candidates, a strategy other than ``aline``.
* ``live.trial`` fires once a trial with ``live.trials`` 1, ``live.observe``
  once an answer; the CPU captures and replays nothing; with tracing off
  no span is made.  The caller's batch is left as it was.

The graphs run on the card: tests/test_torch_cuda.py.
"""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from aline_tpu_torch import config as tcfg  # noqa: E402
from aline_tpu_torch.eval.al_curves import (  # noqa: E402
    al_rollout_curves,
    posterior_curves,
)
from aline_tpu_torch.eval.live import LiveExperiment  # noqa: E402
from aline_tpu_torch.models.aline import build_model  # noqa: E402
from aline_tpu_torch.tasks import build_task  # noqa: E402
from aline_tpu_torch.utils import metrics  # noqa: E402
from aline_tpu_torch.utils.serialization import save_params_npz  # noqa: E402
from portbench import gen_psych  # noqa: E402
from portbench.reference import psych as ref_psych  # noqa: E402
from portbench.reference.model import load_params, precision  # noqa: E402

torch.set_num_threads(1)
WIDTHS = ["encoder.dim_embedding=16", "encoder.dim_feedforward=32",
          "encoder.n_head=2", "encoder.num_layers=2",
          "head.num_components=4"]
GP = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
      "task.n_context_init=1", "task.n_query_init=10",
      "task.n_target_data=4"] + WIDTHS
TIME = ["time_token=true", "encoder.with_time_token=true"]
PSYCH = ["task=psychometric", "task.n_context_init=1",
         "task.n_query_init=12"] + WIDTHS
PSYCH_MASKS = {"threshold_slope": [True, True, False, False],
               "guess_lapse": [False, False, True, True],
               "all": [True, True, True, True]}
T = 5


@pytest.fixture(autouse=True)
def tracing_reset():
    metrics.set_tracing(False)
    metrics.collect()
    yield
    metrics.set_tracing(False)
    metrics.collect()


def _setup(overrides, seed=1, B=3):
    cfg = tcfg.parse_overrides(overrides)
    torch.manual_seed(0)
    model = build_model(cfg, "cpu").eval()
    batch = build_task(cfg.task).sample_batch(
        torch.Generator().manual_seed(seed), B)
    return cfg, model, batch


def _hidden(batch):
    """The batch with every outcome outside the initial context NaN."""
    return batch.replace(y=torch.where(batch.ctx_mask[..., None], batch.y,
                                       torch.nan))


def _fed(model, batch, T, outcomes, **kw):
    """A session fed ``outcomes`` [B, N, 1] at each design it proposes:
    (designs [B, T], the posterior)."""
    s = LiveExperiment(model, _hidden(batch), T, **kw)
    rows = torch.arange(batch.batch_size)
    idxs = []
    for _ in range(T):
        idx, x = s.propose()
        assert torch.equal(x, batch.x[rows, idx])
        s.observe(outcomes[rows, idx])
        idxs.append(idx)
    return torch.stack(idxs, 1), s.posterior()


def _masked(batch, mask):
    if mask == "default":
        return batch
    sel = torch.arange(batch.n_target) < batch.n_target_data
    return batch.replace(target_mask=sel if mask == "data" else ~sel)


def _assert_rollout_equal(model, batch, time_token=False):
    want = al_rollout_curves(model, batch, T, time_token=time_token)
    idx, post = _fed(model, batch, T, batch.y, time_token=time_token)
    assert torch.equal(idx, want["idx"])
    lp, rmse = posterior_curves(post.gmm, batch.target_all[..., 0],
                                post.target_weights)
    assert torch.equal(lp, want["log_prob"][:, -1])
    assert torch.equal(rmse, want["rmse"][:, -1])
    n_ctx0 = int(batch.ctx_mask[0].sum())
    rows = torch.arange(batch.batch_size)[:, None]
    ctx = torch.cat([torch.arange(n_ctx0).expand(batch.batch_size, -1), idx],
                    1)
    assert torch.equal(post.idx, ctx)
    assert torch.equal(post.x, batch.x[rows, ctx])
    assert torch.equal(post.y, batch.y[rows, ctx])


@pytest.mark.parametrize("time_token", [False, True],
                         ids=["plain", "time_token"])
@pytest.mark.parametrize("mask", ["default", "data", "theta"])
def test_gp_session_is_the_rollout_bitwise(mask, time_token):
    _, model, batch = _setup(GP + (TIME if time_token else []))
    _assert_rollout_equal(model, _masked(batch, mask), time_token)


@pytest.mark.parametrize("mask", list(PSYCH_MASKS))
def test_psych_session_is_the_rollout_bitwise(mask):
    _, model, batch = _setup(PSYCH)
    _assert_rollout_equal(model, batch.replace(
        target_mask=torch.tensor(PSYCH_MASKS[mask])))


def test_session_leaves_the_batch_as_it_was():
    _, model, batch = _setup(PSYCH)
    before = {n: t.clone() for n, t in vars(batch).items()
              if isinstance(t, torch.Tensor)}
    _fed(model, batch, T, batch.y)
    for n, t in before.items():
        assert torch.equal(getattr(batch, n), t), n


# -- against the plain reference ---------------------------------------------

@pytest.mark.parametrize("mask", list(PSYCH_MASKS))
def test_session_against_the_reference(mask, tmp_path):
    cfg, model, _ = _setup(PSYCH)
    P = load_params(save_params_npz(str(tmp_path / "p.npz"), model), "cpu")
    arch = dict(num_layers=2, n_head=2, std_min=cfg.head.std_min)
    prec = precision({"model": "float32", "gmm_head_pool": "float32",
                      "gmm_head_pool_min_tokens": 1024})
    task = dict(n_context_init=1, design_scale=cfg.task.design_scale,
                dim_x=1)
    d = gen_psych.subjects(torch.Generator().manual_seed(11), 3,
                           cfg.task.n_query_init, T, task)
    theta, u = d["theta"].tolist(), d["u"].tolist()
    y0 = torch.tensor([[ref_psych.respond(float(d["x"][i, 0, 0]), theta[i],
                                          d["u0"][i, 0])]
                       for i in range(3)])
    y = torch.zeros(d["x"].shape)
    y[:, :1, 0] = y0
    m = torch.tensor(PSYCH_MASKS[mask])
    batch = build_task(cfg.task).sample_batch(torch.Generator(), 3).replace(
        x=d["x"], y=y, target_mask=m)
    s = LiveExperiment(model, batch, T)
    idxs, answers = [], []
    for t in range(T):
        idx, x = s.propose()
        a = [ref_psych.respond(float(x[i, 0]), theta[i], u[i][t])
             for i in range(3)]
        s.observe(a)
        idxs.append(idx)
        answers.append(a)
    post = s.posterior()
    idx = torch.stack(idxs, 1)
    res = ref_psych.replay(P, d["x"], y0, idx, torch.tensor(answers).T,
                           d["theta"], m, post.target_weights, prec, arch)
    assert res["invalid"] == 0
    assert float(res["gap"].max()) <= 1e-4
    lp, rmse = posterior_curves(post.gmm, d["theta"], post.target_weights)
    assert (lp - res["log_prob"][:, -1]).abs().max() <= 1e-4
    assert (rmse - res["rmse"][:, -1]).abs().max() <= 1e-4
    assert torch.equal(post.y[:, 1:, 0], torch.tensor(answers).T)


# -- refusals ----------------------------------------------------------------

def test_refusals():
    _, model, batch = _setup(PSYCH)
    with pytest.raises(ValueError, match="strategy"):
        LiveExperiment(model, batch, T, strategy="uncertainty")
    with pytest.raises(ValueError, match="candidates"):
        LiveExperiment(model, batch, batch.n_points)
    s = LiveExperiment(model, batch, 2)
    with pytest.raises(RuntimeError, match="before propose"):
        s.observe(1.0)
    s.propose()
    with pytest.raises(RuntimeError, match="before observe"):
        s.propose()
    with pytest.raises(RuntimeError, match="waits for its response"):
        s.posterior()
    s.observe([1.0, 0.0, 1.0])
    s.propose()
    s.observe([0.0, 0.0, 1.0])
    with pytest.raises(RuntimeError, match="past T"):
        s.propose()
    s.posterior()
    for call in (s.propose, s.posterior, lambda: s.observe(1.0)):
        with pytest.raises(RuntimeError, match="ended"):
            call()


# -- spans and counters ------------------------------------------------------

def test_trial_spans_and_counters():
    _, model, batch = _setup(PSYCH)
    metrics.set_tracing(True)
    _fed(model, batch, T, batch.y)
    spans = metrics.collect()
    trials = [s for s in spans if s.name == "live.trial"]
    assert len(trials) == T
    assert all(s.counts.get("live.trials") == 1 for s in trials)
    assert sum(s.name == "live.observe" for s in spans) == T
    for name in ("live.graph_captures", "live.graph_replays"):
        assert sum(s.counts.get(name, 0) for s in spans) == 0
    # the step's forward and choice run inside the trial's span
    by_id = {s.id: s for s in spans}
    forwards = [s for s in spans if s.name == "model.forward"]
    assert len(forwards) == T + 1
    assert sum(by_id.get(s.parent) in trials for s in forwards) == T


def test_tracing_off_makes_no_span(monkeypatch):
    def made(*a, **kw):
        raise AssertionError("a span was made with tracing off")

    _, model, batch = _setup(PSYCH)
    monkeypatch.setattr(metrics, "Span", made)
    _fed(model, batch, T, batch.y)
    assert metrics.collect() == []
