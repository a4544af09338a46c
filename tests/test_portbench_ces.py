"""The benchmark's CES cell (``portbench/kinds/bed_ces.py``) and its plain
reference (``portbench/reference/ces.py``) on the CPU, at tiny sizes.

* The reference's censored sigmoid-normal log-likelihood against the
  program's ``CESTask.log_likelihood``, float32, on interior outcomes, on
  both limits and at rho near 0.01 (where the outer power 1/rho
  multiplies the rounding of the weighted sum): within 1e-6 of
  max(|ll|, 1), four float32 ulps of its size (measured: 2.4e-7).  The
  two sum the same terms in another order.
* The reference's sPCE/sNMC against ``compute_eig_from_history`` on the
  same draw rule, B=6, Th=5, L=3000, L_chunk=700 (5 chunks, the last
  padded), for the whole batch and for two of its rows: within 1e-4
  abs, the float32 rounding of two orders of summation (measured:
  1e-6), as ``tests/test_torch_eig.py`` holds location finding.
* The cell end to end (B=6, n_query=20, T=4, L=3000, L_chunk=700): correct
  with the model in float32 and in bfloat16 under the committed limits;
  the kind's control (the reference one precision lower in the program's
  place) and a run whose bounds are broken underneath are not.
* A traced run reads the cell's per-layer metrics that the program
  allows: all six where CES folds through the generic fold (the
  reference's tails); five through its kernel (no ``eig.loglik`` span:
  the likelihood's share is left out); on a program without the fold's
  inner spans and counter (as before they were added) the other four.
"""
import contextlib
import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from aline_tpu_torch import config as tcfg  # noqa: E402
from aline_tpu_torch.eval import eig  # noqa: E402
from aline_tpu_torch.eval.eig import compute_eig_from_history  # noqa: E402
from aline_tpu_torch.tasks import build_task  # noqa: E402
from aline_tpu_torch.utils import metrics  # noqa: E402
from portbench import control, harness, program  # noqa: E402
from portbench import run as R  # noqa: E402
from portbench.gen_ces import ces_batch  # noqa: E402
from portbench.harness import (  # noqa: E402
    checks_from, load_config, load_kind, load_limits, load_traffic)
from portbench.reference import ces as rc  # noqa: E402
from portbench.reference.model import Rounder  # noqa: E402

torch.set_num_threads(1)
CELL = "ces_200k.bed_L1e7"
TINY = dict(batch_size=6, n_query=20, T=4, L=3000, L_chunk=700, n_inputs=3,
            check_rows=4, reference_block_rows=2)
SEED = 2**31 + 977
F32 = Rounder("float32")
METRICS = ("idle_share.ces", "mfu.ces", "eig_fold_roofline.ces",
           "eig_fold.share.ces", "loglik.share.ces", "eig_gterms_per_s.ces")
NEW_SPAN_METRICS = ("loglik.share.ces", "eig_gterms_per_s.ces")


def _task():
    cfg = tcfg.parse_overrides(["task=ces"]).task
    return build_task(cfg), dict(epsilon=cfg.epsilon,
                                 noise_scale=cfg.noise_scale,
                                 design_scale=cfg.design_scale,
                                 n_context_init=cfg.n_context_init)


def _parts(f32: bool = False):
    cf = copy.deepcopy(load_config("ces_200k"))
    tr = dict(load_traffic("bed_ces"), **TINY)
    if f32:
        cf["run"]["dtype"] = "float32"
        cf["precision"]["model"] = "float32"
    return cf, tr


def _run(f32: bool = False, trace: bool = False, tail_mode: str = None):
    cf, tr = _parts(f32)
    if tail_mode is not None:
        cf["run"]["task"]["tail_mode"] = tail_mode
    return R.execute(CELL, SEED, 0.3, trace, "cpu", config=cf, traffic=tr)


@pytest.mark.parametrize("case", ["interior", "lower", "upper", "rho_small"])
def test_reference_loglik_matches_the_task(case):
    t, task = _task()
    g = torch.Generator().manual_seed(11)
    n = 4000
    theta = rc.prior(g, (n,))
    if case == "rho_small":
        theta[:, 0] = 0.01 + 0.01 * torch.rand(n, generator=g)
    x = 100.0 * torch.rand(n, 6, generator=g)
    if case in ("interior", "rho_small"):
        # half uniform, half the model's own ratings (mostly at a limit)
        mu, sigma = rc.response(x, theta, task["noise_scale"], F32)
        own = torch.sigmoid(mu + sigma * torch.randn(n, generator=g))
        y = torch.where(torch.rand(n, generator=g) < 0.5,
                        torch.rand(n, generator=g).clamp(1e-6, 1 - 1e-6),
                        own.clamp(task["epsilon"], 1 - task["epsilon"]))
        y = y[:, None]
    else:
        e = task["epsilon"]
        y = torch.full((n, 1), e if case == "lower" else 1.0 - e)
    want = t.log_likelihood(y, x, theta)[..., 0]
    got = rc.loglik(y, x, theta, task, F32)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-6 * want.abs().clamp(min=1.0)).all()


def test_reference_loglik_is_minus_inf_outside_the_limits():
    _, task = _task()
    e = task["epsilon"]
    y = torch.tensor([[e / 2], [1.0 - e / 4]])
    theta = rc.prior(torch.Generator().manual_seed(1), (2,))
    ll = rc.loglik(y, torch.full((2, 6), 50.0), theta, task, F32)
    assert torch.equal(ll, torch.full((2,), -torch.inf))


@pytest.mark.parametrize("rows", [None, [1, 4]])
def test_reference_bounds_match_the_program(rows):
    t, task = _task()
    g = torch.Generator().manual_seed(5)
    d = ces_batch(g, 6, 20, task)
    x, y, theta = d["x"][:, :5], d["y"][:, :5], d["theta"]
    pce, nmc = compute_eig_from_history(t, theta, x, y, 3000, 77,
                                        L_chunk=700, stepwise=True)
    sel = slice(None) if rows is None else torch.tensor(rows)
    r_pce, r_nmc = rc.ces_bounds(theta[sel], x[sel], y[sel], 3000, 77, 700,
                                 task, F32, B_draw=6,
                                 rows=None if rows is None else sel)
    assert torch.isfinite(pce).all() and torch.isfinite(r_pce).all()
    assert (r_pce - pce[sel]).abs().max() <= 1e-4
    assert (r_nmc - nmc[sel]).abs().max() <= 1e-4


@pytest.mark.parametrize("f32", [True, False], ids=["float32", "bfloat16"])
def test_sound_runs_are_correct(f32):
    res, checks = _run(f32)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"design_gap", "history_mismatch",
                                  "pce_gap", "nmc_gap"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"bed_rollouts_per_s", "setup_s"}


def test_control_is_not_correct():
    cf, tr = _parts()
    readings = load_kind("bed_ces").control(cf, tr, program.device("cpu"),
                                            2**31 + 3)
    assert not all(c.ok for c in checks_from(readings, load_limits(CELL)))


@pytest.mark.parametrize("fault", ["bound_altered", "half_batch"])
def test_broken_bounds_are_not_correct(fault, monkeypatch):
    control.plant(CELL, fault, monkeypatch.setattr)
    res, _ = _run(f32=True)
    assert not res["correct"], res["checks"]


@contextlib.contextmanager
def _profiled(out):
    """The profiled slice, as the card's trace would summarise it."""
    yield
    out.update(busy_s=0.9, window_s=1.0, n_device=10, by_name={},
               breakdown={})


def _without_new_spans(monkeypatch):
    """The fold as it was before ``eig.loglik``, ``eig.lse`` and
    ``eig.terms``: the chunk span alone."""
    def span(name):
        if name in ("eig.loglik", "eig.lse"):
            return contextlib.nullcontext()
        return metrics.span(name)
    monkeypatch.setattr(eig, "span", span)
    monkeypatch.setattr(eig, "count", lambda name, n: None)


@pytest.mark.parametrize("program_has_them", [True, False, "generic_fold"],
                         ids=["with_new_spans", "without_new_spans",
                              "generic_fold"])
def test_traced_run_reads_the_metrics_the_program_allows(program_has_them,
                                                         monkeypatch):
    """The program as it is folds CES through its kernel, whose chunks
    count ``eig.terms`` and hold no ``eig.loglik``: the likelihood's share
    is left out.  With the reference's tails (the generic fold) it is
    read too; without the chunk's counter the throughput is left out as
    well."""
    load = harness.load_kind

    def load_kind_profiled(name, base=harness.HERE):
        mod = load(name, base)
        mod.traced = _profiled
        return mod

    monkeypatch.setattr(R, "load_kind", load_kind_profiled)
    if not program_has_them:
        _without_new_spans(monkeypatch)
    generic = program_has_them == "generic_fold"
    try:
        res, _ = _run(f32=True, trace=True,
                      tail_mode="reference" if generic else None)
    finally:
        metrics.set_tracing(False)
        metrics.collect()
    want = set(METRICS) - ({"loglik.share.ces"} if not generic else set())
    if not program_has_them:
        want -= set(NEW_SPAN_METRICS)
    assert set(res["metrics"]) == want
    for name in want:
        assert res["metrics"][name]["value"] > 0, name
    if generic:
        assert 0 < res["metrics"]["loglik.share.ces"]["value"] <= 100
