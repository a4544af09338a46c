"""The port's BED entry points on the CPU at tiny sizes:
``python -m aline_tpu_torch.eval_bed`` (the counterpart of
``scripts/eval_bed.py``: its flags, its file names and keys, no quiet
fall-back to the CPU) and ``python -m aline_tpu_torch.train`` with
``eval.EIG=true`` (``train.py``'s in-training bounds in metrics.jsonl and
its final per-step bounds)."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from aline_tpu_torch import eval_bed
from aline_tpu_torch.train.__main__ import main as train_main

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOC_RUN = os.path.join(ROOT, "checkpoints", "loc_100k")
# the keys scripts/eval_bed.py writes: the policy's with an aline_
# prefix, the random designs' with random_
KEYS = ("pce_mean", "pce_err", "nmc_mean", "nmc_err")


def _run_copy(tmp_path):
    run_dir = tmp_path / "loc_100k"
    run_dir.mkdir()
    shutil.copy(os.path.join(LOC_RUN, "config.json"), run_dir)
    return str(run_dir)


TINY = ["--device", "cpu", "--L", "300", "--M", "6", "--batch-size", "4",
        "--n-query", "20", "--T", "3", "--L-chunk", "128"]


def test_eval_bed_writes_the_scripts_file_and_keys(tmp_path):
    run_dir = _run_copy(tmp_path)
    out = eval_bed.main([run_dir, *TINY, "--with-random-baseline"])
    path = os.path.join(run_dir, "eval", "bed_bounds_N20_T3_L300.npz")
    with np.load(path) as f:
        assert sorted(f.files) == sorted(
            [f"aline_{k}" for k in KEYS] + [f"random_{k}" for k in KEYS])
        for k in f.files:
            assert f[k].shape == (4,), k          # n_context_init + T
            assert np.isfinite(f[k]).all(), k
            np.testing.assert_array_equal(f[k], out[k])
        for who in ("aline", "random"):
            assert (f[f"{who}_nmc_mean"]
                    >= f[f"{who}_pce_mean"] + np.log(300 / 301) - 1e-5).all()
            assert (f[f"{who}_pce_mean"] <= np.log(301) + 1e-5).all()
    # same seed, same bounds; the random designs stand alone
    again = eval_bed.main([run_dir, *TINY, "--skip-policy",
                           "--with-random-baseline"])
    with np.load(os.path.join(run_dir, "eval",
                              "random_bounds_N20_T3_L300.npz")) as f:
        assert sorted(f.files) == sorted(f"random_{k}" for k in KEYS)
        for k in f.files:
            np.testing.assert_array_equal(f[k], again[k])
            np.testing.assert_array_equal(f[k], out[k])


def test_eval_bed_default_T_comes_from_the_config(tmp_path):
    run_dir = _run_copy(tmp_path)
    args = [a for a in TINY if a not in ("--T", "3")]
    out = eval_bed.main([run_dir, *args, "--L", "50", "--M", "2",
                         "--batch-size", "2", "--n-query", "40"])
    # loc_100k: eval.T_final 35, n_context_init 1 → T = 34 and 35 steps
    assert out["aline_pce_mean"].shape == (35,)
    assert os.path.exists(os.path.join(run_dir, "eval",
                                       "bed_bounds_N40_T34_L50.npz"))


def test_eval_bed_refuses_to_fall_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run_dir = _run_copy(tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "aline_tpu_torch.eval_bed", run_dir,
         "--L", "10", "--M", "2", "--batch-size", "2", "--n-query", "5",
         "--T", "2"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not os.path.exists(os.path.join(run_dir, "eval"))


def test_eval_bed_reads_a_port_trained_runs_own_weights(tmp_path):
    # a port run of the loc recipe at loc_100k's widths: the committed
    # loc_100k npz fits its model too, so only the run's file may be read
    run = tmp_path / "run"
    train_main(["device=cpu", "task=location_finding", "task.n_query_init=10",
                "batch_size=4", "min_T=2", "T=2", "max_epoch=2",
                "burning_epoch=1", "checkpoint=0", "verbose=1000",
                "file_name=aline_loc.pth", f"output_dir={run}"])
    own = eval_bed.main([str(run), "--file-name", "aline_loc", *TINY])
    given = eval_bed.main([str(run), "--params",
                           str(run / "model" / "aline_loc.npz"), *TINY])
    loc = eval_bed.main([str(run), "--params",
                         str(eval_bed.LOC_100K_PARAMS), *TINY])
    for k in KEYS:
        np.testing.assert_array_equal(own[f"aline_{k}"], given[f"aline_{k}"])
    assert not np.array_equal(own["aline_pce_mean"], loc["aline_pce_mean"])
    # no model/aline.npz and not loc_100k's config: no weights to guess
    with pytest.raises(FileNotFoundError, match="pass --params"):
        eval_bed.main([str(run), *TINY])


def test_eval_bed_takes_the_committed_weights_only_for_loc_100k(tmp_path):
    run_dir = _run_copy(tmp_path)
    assert eval_bed.weights_path(run_dir, "aline") == str(
        eval_bed.LOC_100K_PARAMS)
    with open(os.path.join(LOC_RUN, "config.json")) as f:
        assert json.load(f) == json.loads(
            eval_bed.LOC_100K_CONFIG.read_text())
    cfg_path = os.path.join(run_dir, "config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["output_dir"] = "outputs/loc_torch"
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(FileNotFoundError):
        eval_bed.weights_path(run_dir, "aline")
    assert eval_bed.weights_path(run_dir, "aline", "x.npz") == "x.npz"


def test_train_cli_logs_finite_bounds(tmp_path):
    run = tmp_path / "run"
    train_main(["device=cpu", "task=location_finding", "eval.EIG=true",
                "task.n_query_init=10", "encoder.dim_embedding=16",
                "encoder.dim_feedforward=32", "encoder.n_head=2",
                "encoder.num_layers=2", "head.num_components=4",
                "batch_size=4", "min_T=3", "T=3", "max_epoch=4",
                "burning_epoch=2", "checkpoint=0", "verbose=2",
                "eval.L=200", "eval.M=4", "eval.batch_size=2",
                "eval.L_final=100", "eval.M_final=2",
                "eval.batch_size_final=2", "eval.n_query_final=8",
                "eval.T_final=4", "file_name=aline_loc.pth",
                f"output_dir={run}"])
    recs = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    bounds = [r for r in recs if "pce_mean" in r]
    assert [r["step"] for r in bounds] == [0, 2]            # every verbose
    for r in bounds:
        assert np.isfinite(r["pce_mean"]) and np.isfinite(r["nmc_mean"])
        assert r["nmc_mean"] >= r["pce_mean"] + np.log(200 / 201) - 1e-5
    with np.load(run / "eval" / "aline_loc_N8_T4.npz") as f:
        assert sorted(f.files) == sorted(KEYS)
        assert f["pce_mean"].shape == (4,)        # T_final - 1 + 1 steps
        assert np.isfinite(f["pce_mean"]).all()
    assert (run / "model" / "aline_loc.npz").exists()
