"""The benchmark's psychometric cell (``portbench/kinds/live_subjects.py``),
its generator (``portbench/gen_psych.py``) and its plain reference
(``portbench/reference/psych.py``) on the CPU, at the kind's tiny sizes and
the published widths and weights.

* The tiny cell runs end to end and is correct under the committed limits
  with the model in float32 and in bfloat16; its line has the cell's two
  end-to-end metrics.
* The generator repeats from its seed, differs across seeds, and draws
  within the task's ranges.
* The reference and the generator import nothing of the program; the
  reference's answer probability is the program task's
  ``psychometric_function`` (float32 there, double here: within 1e-6).
* A planted fault fails its check: one answer flipped in the program's
  context (``response_mismatch``); stimuli chosen by a lower precision
  (the kind's control, the reference one step below the configuration's).
* A traced run reads the cell's three per-layer metrics (the profiled
  slice's summary given, as the card's trace would give it), the trial
  spans and the ``live.trials`` counter from the program's tracing.
"""
import ast
import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from aline_tpu_torch import config as tcfg  # noqa: E402
from aline_tpu_torch.tasks import build_task  # noqa: E402
from aline_tpu_torch.utils import metrics  # noqa: E402
from portbench import gen_psych, harness  # noqa: E402
from portbench import run as R  # noqa: E402
from portbench.harness import (  # noqa: E402
    checks_from, load_config, load_kind, load_limits, load_traffic)
from portbench.reference import psych as ref  # noqa: E402

torch.set_num_threads(1)
CELL = "psych_100k.live_b1"
KIND = load_kind("live_subjects")
SEED = 2**31 + 977
METRICS = ("trial_ms_p95.psych", "kernels_per_trial.psych",
           "idle_share.psych")
TASK = dict(n_context_init=1, design_scale=5.0, dim_x=1)


@pytest.fixture(autouse=True)
def tracing_reset():
    metrics.set_tracing(False)
    metrics.collect()
    yield
    metrics.set_tracing(False)
    metrics.collect()


def _parts(f32=False):
    c = harness.find_cell(harness.load_benchmark(), CELL)
    cf = copy.deepcopy(load_config(c["config"]))
    tr = dict(load_traffic(c["traffic"]), **KIND.TINY)
    if f32:
        cf["run"]["dtype"] = "float32"
        cf["precision"]["model"] = "float32"
    return cf, tr


def _run(f32=False, trace=False, seed=SEED):
    cf, tr = _parts(f32)
    return R.execute(CELL, seed, 0.1, trace, "cpu", config=cf, traffic=tr)


# -- the cell ---------------------------------------------------------------

@pytest.mark.parametrize("f32", [True, False], ids=["float32", "bfloat16"])
def test_sound_runs_are_correct(f32):
    res, _ = _run(f32=f32)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"design_gap", "response_mismatch",
                                  "invalid_choices", "log_prob_gap",
                                  "rmse_gap"}
    assert set(res["metrics"]) == {"experiment_ms_p95", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_fault_response_flipped_is_not_correct(monkeypatch):
    KIND.plant("response_flipped", monkeypatch.setattr)
    res, _ = _run(f32=True)
    assert not res["correct"], res["checks"]
    assert res["checks"]["response_mismatch"]["value"] > 0


def test_stimuli_of_a_lower_precision_are_not_correct():
    cf, tr = _parts()
    readings = KIND.control(cf, tr, torch.device("cpu"), 2**31 + 3)
    assert set(readings) == set(load_limits(CELL)) - {"why"}
    assert not all(c.ok for c in checks_from(readings, load_limits(CELL)))


# -- the generator and the reference -----------------------------------------

def test_generator_repeats_from_its_seed():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return gen_psych.subjects(g, 5, 30, 7, TASK)

    a, b, c = draw(2**31 + 5), draw(2**31 + 5), draw(2**31 + 6)
    assert set(a) == {"theta", "x", "u0", "u"}
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert not torch.equal(a[k], c[k]), k
    assert a["x"].shape == (5, 31, 1) and a["u"].shape == (5, 7)
    assert a["x"].abs().max() <= 5.0
    for i, (lo, hi) in enumerate(ref.RANGES):
        assert lo <= a["theta"][:, i].min() and a["theta"][:, i].max() <= hi


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", ["portbench/reference/psych.py",
                                  "portbench/gen_psych.py"])
def test_reference_imports_nothing_of_the_program(path):
    full = os.path.join(ROOT, path)
    assert not _imported(full) & {"aline_tpu_torch", "aline_tpu", "jax",
                                  "flax"}
    assert "aline_tpu_torch" not in open(full).read()


def test_reference_probability_is_the_tasks():
    cfg = tcfg.parse_overrides(["task=psychometric"])
    task = build_task(cfg.task)
    g = torch.Generator().manual_seed(4)
    theta = task.sample_theta(g, (64,))[..., 0]
    x = -5.0 + 10.0 * torch.rand(64, 1, generator=g)
    want = task.psychometric_function(x, theta)[:, 0]
    got = torch.tensor([ref.probability(float(a), t)
                        for a, t in zip(x[:, 0], theta.tolist())])
    assert (got - want.double()).abs().max() <= 1e-6
    assert ref.respond(0.0, (0.0, 1.0, 0.5, 0.0), 0.5) == 1.0
    assert ref.respond(0.0, (0.0, 1.0, 0.5, 0.0), 0.7) == 0.0


# -- the traced run ---------------------------------------------------------

def _summary(prof, window):
    assert not any(e.name.startswith("aline/") for e in prof.events())
    return dict(busy_s=0.1, window_s=1.0, n_device=3000,
                by_name={"ampere_bf16_gemm": (500, 0.05)}, breakdown={})


def test_traced_run_reads_the_metrics(monkeypatch):
    load = harness.load_kind

    def load_kind_profiled(name, base=harness.HERE):
        mod = load(name, base)
        if name == "live_subjects":
            mod.summarise = _summary
        return mod

    monkeypatch.setattr(R, "load_kind", load_kind_profiled)
    res, _ = _run(f32=True, trace=True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(METRICS)
    traced = KIND.TINY["trace_units"] * KIND.TINY["T"]
    assert res["metrics"]["kernels_per_trial.psych"]["value"] == \
        3000 / traced
    assert res["metrics"]["idle_share.psych"]["value"] == pytest.approx(90)
    assert res["metrics"]["trial_ms_p95.psych"]["value"] > 0
