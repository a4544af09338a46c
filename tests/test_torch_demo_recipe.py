"""The 5k-epoch demo recipe (checkpoints/al1d_5k_demo) in the port, and
the tools that hold a port run to the JAX package's seed study.

* ``seed_study.DEMO_RECIPE + DEMO_RUN`` (the overrides a card run takes)
  resolves through the port's ``parse_overrides`` to the demo's
  config.json in every key but ``output_dir``, ``verbose``, ``checkpoint``
  and ``load_checkpoint``; the keys the port added since (the static-mask
  switches) stand at the JAX package's defaults.
* A tiny run of the recipe, stopped and resumed, through the repo's
  numpy-only reports run unchanged on the port's outputs (by
  ``subprocess``, every output in ``tmp_path``):
  ``scripts/plateau_report.py`` on its run directory and
  ``scripts/paired_al_stats.py --out`` on its ``eval_al`` npz.
  ``scripts/seed_variance_report.py`` writes into ``benchmarks/artifacts``
  by a fixed path, so it is not run.
* ``seed_study``: the resumed run's records (one clock a segment, the
  last record of a repeated step kept) and epoch times; criteria (b) and
  (c) on the study's own seed-8 rows, which must meet them, and on a
  worse copy, which must not; a run without the window misses (a); the
  paired reading of two evals of the same rows is 0.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from aline_tpu import config as jcfg
from aline_tpu_torch import eval_al, seed_study
from aline_tpu_torch.config import parse_overrides, to_dict
from aline_tpu_torch.train.__main__ import main as train_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "checkpoints", "al1d_5k_demo")
ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
FREE = {"output_dir", "verbose", "checkpoint", "load_checkpoint"}
TINY = ["device=cpu", "task.n_query_init=12", "task.n_target_data=6",
        "batch_size=4", "min_T=3", "T=3", "burning_epoch=3", "verbose=1",
        "checkpoint=4"]


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


def test_demo_overrides_resolve_to_the_banked_config():
    got = _flat(to_dict(parse_overrides(list(seed_study.DEMO_RECIPE
                                             + seed_study.DEMO_RUN))))
    with open(os.path.join(DEMO, "config.json")) as f:
        want = _flat(json.load(f))
    assert {k.split("=")[0] for k in seed_study.DEMO_RUN} == FREE
    for key, value in want.items():
        if key not in FREE:
            assert got[key] == value, key
    jax_defaults = _flat(jcfg.to_dict(jcfg.parse_overrides([])))
    for key in set(got) - set(want):
        assert got[key] == jax_defaults[key], key
    assert got["output_dir"] == "outputs/port_al1d_seed8"


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The recipe at tiny sizes: 6 epochs, checkpoint at 4, then resumed
    to 8 (so epochs 4 and 5 are logged twice)."""
    out = tmp_path_factory.mktemp("demo") / "run"
    base = list(seed_study.DEMO_RECIPE) + TINY + [
        f"output_dir={out}", "load_checkpoint=true"]
    first = train_main(base + ["max_epoch=6"])
    assert first.start_epoch == 0
    # the schedule follows max_epoch: the resumed part trains to 8
    train_main(base + ["max_epoch=8"])
    eval_al.main([str(out), "--device", "cpu", "--batch-size", "3",
                  "--T", "2", "--n-query", "8", "--mask", "data",
                  "--seeds", "0,1"])
    return out


def test_plateau_report_reads_the_port_run(tiny_run, tmp_path):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "plateau_report.py"),
         str(tiny_run)], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    row = [ln for ln in proc.stdout.splitlines() if str(tiny_run) in ln]
    assert len(row) == 1
    # label, last epoch 7, no budget, the mean of the last 5 likelihoods
    fields = row[0].split()
    assert fields[1] == "7"
    recs = seed_study.metric_records(str(tiny_run / "metrics.jsonl"))
    ll = seed_study.likelihood_by_step(recs)
    assert float(fields[3]) == pytest.approx(
        np.mean([ll[s] for s in sorted(ll)[-5:]]), abs=1e-3)


def test_paired_al_stats_reads_the_port_eval(tiny_run, tmp_path):
    npz = tiny_run / "eval" / "al_curves_data_mask.npz"
    out = tmp_path / "paired.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "paired_al_stats.py"),
         str(npz), "--out", str(out)], cwd=tmp_path, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(out.read_text())
    assert stats and os.listdir(tmp_path) == ["paired.json"]
    text = json.dumps(stats)
    assert "random" in text and "uncertainty" in text


def test_seed_study_reads_a_resumed_run(tiny_run):
    recs = seed_study.metric_records(str(tiny_run / "metrics.jsonl"))
    assert {r["segment"] for r in recs} == {0, 1}
    steps = [r["step"] for r in recs]
    assert steps == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    ll = seed_study.likelihood_by_step(recs)
    assert sorted(ll) == list(range(8))
    assert ll[5] == [r for r in recs if r["step"] == 5][-1]["likelihood"]
    per = seed_study.epoch_seconds(recs, burning_epoch=3)
    # within a segment only: 0-1, 1-2, 2-3 burning; 3-4, 4-5 main in the
    # first clock, 4-5, 5-6, 6-7 in the second
    assert len(per["burning"]) == 3 and len(per["main"]) == 5
    assert all(s > 0 for v in per.values() for s in v)
    res = seed_study.hold(str(tiny_run), artifacts=ARTIFACTS)
    assert res["segments"] == 2 and res["last_logged_epoch"] == 7
    assert not res["criteria"]["a"]["met"]            # no epoch 4000-4750
    assert res["eval"]["aline"]["log_prob"][2] == 6   # 2 seeds x 3 rows
    with pytest.raises(SystemExit):
        seed_study.main([str(tiny_run), "--artifacts", ARTIFACTS])


def _study_eval(path, shift=0.0):
    """An eval_al npz of the study's seed-8 rows, aline's LL moved by
    ``shift``."""
    with np.load(os.path.join(ARTIFACTS,
                              "al1d_r3_final_eval_seed_variance.npz")) as d:
        arrays = {k[len("seed8_"):]: d[k] for k in d.files
                  if k.startswith("seed8_")}
    arrays["aline_log_prob"] = arrays["aline_log_prob"] + shift
    np.savez(path, **arrays, seeds=np.array([0]))
    return str(path)


@pytest.mark.parametrize("shift,met", [(0.0, True), (-0.5, False)])
def test_seed_study_criteria_on_the_study_rows(tiny_run, tmp_path, shift,
                                               met):
    run = tmp_path / "run"
    (run / "eval").mkdir(parents=True)
    for name in ("config.json", "metrics.jsonl"):
        (run / name).write_text((tiny_run / name).read_text())
    _study_eval(run / "eval" / "al_curves_data_mask.npz", shift)
    demo = _study_eval(tmp_path / "demo.npz", shift)
    res = seed_study.hold(str(run), demo, ARTIFACTS)
    assert res["criteria"]["b"]["met"] is met
    assert res["criteria"]["c"]["met"] is met
    assert res["criteria"]["b"]["log_prob"]["limits"] == pytest.approx(
        (0.819, 1.082), abs=1e-3)
    assert res["criteria"]["b"]["rmse"]["limits"] == pytest.approx(
        (0.119, 0.162), abs=1e-3)
    assert res["criteria"]["a"]["limits"] == pytest.approx((0.416, 0.716),
                                                           abs=1e-3)
    if met:
        assert res["criteria"]["c"]["sigmas"] == 0.0
    # the run's rows against the demo's, pairwise: the shift alone
    assert res["paired"]["log_prob"][0] == pytest.approx(0.0, abs=1e-6)
    assert res["paired"]["log_prob"][1] == pytest.approx(0.0, abs=1e-6)
    assert res["paired"]["rmse"][:2] == (0.0, 0.0)
