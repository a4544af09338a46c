"""The banked runs of CES, psychometric and HPO-B in the port, and its
entry points for them, on the CPU at tiny sizes.

* Every committed npz (``aline_tpu_torch/assets/<run>_params.npz``)
  equals the run's orbax checkpoint bitwise, is what the weights table
  (``utils/serialization.py`` ``weights_path``) gives a copy of the run's
  directory, and one forward of the port on it equals the JAX model's on
  that run's batch within 1e-4 (both in float32, through a copy of the
  config set to float32; the run's own bf16 is held module by module in
  ``tests/test_torch_bf16.py``).  One case per run.
* ``eval_psychometric``, ``eval_psi``, ``eval_hpo`` and ``eval_bed`` on
  ``ces_200k``: their ``main`` with ``--device cpu`` writes the scripts'
  files and keys; without it, and without a card, each refuses to run.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.tasks import build_task as jax_build_task
from aline_tpu.utils.serialization import load_config as jax_load_config
from aline_tpu.utils.serialization import load_config_and_model
from aline_tpu_torch import eval_bed, eval_hpo, eval_psi, eval_psychometric
from aline_tpu_torch.tasks import batch_from_numpy
from aline_tpu_torch.utils.serialization import (
    BANKED_RUNS,
    load_model,
    weights_path,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_RUNS = ("ces_200k", "psych_100k", "hpo_glmnet_15k", "hpo_ranger_15k",
            "hpo_rpart_15k", "hpo_rpart_45k", "hpo_svm_15k",
            "hpo_xgboost_15k", "al1d_5k_demo")


def _run_copy(tmp_path, run, **changes):
    """A copy of checkpoints/<run>'s config.json (with ``changes``) in a
    fresh directory."""
    dst = tmp_path / run
    dst.mkdir()
    with open(os.path.join(ROOT, "checkpoints", run, "config.json")) as f:
        cfg = json.load(f)
    cfg.update(changes)
    with open(dst / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(dst)


def _jax_batch(cfg):
    task = jax_build_task(cfg.task)
    if cfg.task.target != "hpo":
        return task.sample_batch(jax.random.key(2), 3, n_query=12)
    cx, cy, qx, qy, tx, ty = (a[:3] for a in task.hpob.sample_test_set(
        task.n_context_init, 12, 8))
    return task._pack_batch(jnp.asarray(np.concatenate([cx, qx], 1)),
                            jnp.asarray(np.concatenate([cy, qy], 1)),
                            jnp.asarray(tx), jnp.asarray(ty),
                            jnp.zeros((3, 0, 1)), None)


@pytest.mark.parametrize("run", NEW_RUNS)
def test_banked_npz_is_the_checkpoint_and_runs_as_jax(tmp_path, run):
    run_dir = os.path.join(ROOT, "checkpoints", run)
    config_copy, npz = BANKED_RUNS[run]
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg_json = json.load(f)
    assert json.loads(config_copy.read_text()) == cfg_json
    assert weights_path(_run_copy(tmp_path, run), "aline") == str(npz)
    _, _, params = load_config_and_model(
        run_dir, cfg_json["file_name"].split(".")[0])
    want = {k: np.asarray(v) for k, v in flatten_dict(params,
                                                       sep="/").items()}
    with np.load(npz) as f:
        flat = {k: f[k] for k in f.files}
    assert sorted(flat) == sorted(want)
    for k, v in flat.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, want[k], err_msg=k)

    jcfg = jax_load_config(run_dir)
    jcfg.dtype = "float32"
    jbatch = _jax_batch(jcfg)
    jmodel = jax_build_model(jcfg)
    jout = jmodel.apply(unflatten_dict({k: jnp.asarray(v)
                                        for k, v in flat.items()}, sep="/"),
                        jbatch, training=False)
    (tmp_path / "f32").mkdir()
    f32_dir = _run_copy(tmp_path / "f32", run, dtype="float32")
    _, model = load_model(f32_dir, npz, "cpu")
    with torch.no_grad():
        tout = model(batch_from_numpy(jbatch), training=False)
    np.testing.assert_array_equal(tout.design_out.idx.numpy(),
                                  np.asarray(jout.design_out.idx))
    np.testing.assert_allclose(tout.design_out.zt.numpy(),
                               np.asarray(jout.design_out.zt), rtol=1e-4,
                               atol=1e-4)
    for part in ("posterior_out", "posterior_out_query"):
        for name in ("mixture_means", "mixture_stds", "mixture_weights"):
            np.testing.assert_allclose(
                getattr(getattr(tout, part), name).numpy(),
                np.asarray(getattr(getattr(jout, part), name)), rtol=1e-4,
                atol=1e-4, err_msg=f"{part}.{name}")


def test_psychometric_and_psi_entries_on_cpu(tmp_path, capsys):
    run_dir = _run_copy(tmp_path, "psych_100k")
    tiny = ["--device", "cpu", "--T", "3", "--batch-size", "3",
            "--n-query", "15", "--seeds", "0,1"]
    pol = eval_psychometric.main([run_dir, *tiny])
    path = os.path.join(run_dir, "eval", "psychometric_curves.npz")
    with np.load(path) as f:
        names = [f"{pre}{m}_{k}" for pre in ("", "seed1_")
                 for m in eval_psychometric.MASKS
                 for k in ("log_prob", "rmse")]
        assert sorted(f.files) == sorted(names + ["seeds"])
        np.testing.assert_array_equal(f["seeds"], [0, 1])
        for k in names:
            assert f[k].shape == (3, 4) and np.isfinite(f[k]).all()
            np.testing.assert_array_equal(f[k], pol[k])
    out = str(tmp_path / "psi.npz")
    res = eval_psi.main([run_dir, *tiny, "--grid", "5,3,3,3",
                         "--policy-npz", path, "--out", out])
    printed = capsys.readouterr().out
    assert "paired dLL(psi - policy)" in printed
    with np.load(out) as f:
        assert len(f.files) == 2 * 3 * 2 * 2 + 1
        for k in f.files:
            np.testing.assert_array_equal(f[k], res[k])
        assert f["threshold_slope_psi_log_prob"].shape == (3, 4)


def test_hpo_entry_on_cpu(tmp_path):
    run_dir = _run_copy(tmp_path, "hpo_ranger_15k")
    res = eval_hpo.main([run_dir, "--device", "cpu", "--T", "2",
                         "--n-query", "10", "--n-target", "6",
                         "--seeds", "0,1"])
    with np.load(os.path.join(run_dir, "eval",
                              "hpo_test_curves.npz")) as f:
        assert "seeds" in f.files
        for pre in ("", "seed1_"):
            for s in ("aline", "random", "uncertainty"):
                for k in ("log_prob", "rmse"):
                    v = f[f"{pre}{s}_{k}"]
                    assert v.shape == (30, 3) and np.isfinite(v).all()
                    np.testing.assert_array_equal(v, res[f"{pre}{s}_{k}"])
    # the policy is greedy on a fixed test set: seeds change only random
    np.testing.assert_array_equal(res["aline_log_prob"],
                                  res["seed1_aline_log_prob"])
    shift = eval_hpo.main([run_dir, "--device", "cpu", "--T", "1",
                           "--n-query", "10", "--n-target", "6",
                           "--meta-dataset", "ranger_shift",
                           "--out-name", "shift.npz"])
    assert shift["aline_log_prob"].shape[1] == 2
    assert os.path.exists(os.path.join(run_dir, "eval", "shift.npz"))


def test_eval_bed_on_ces_through_the_table(tmp_path):
    run_dir = _run_copy(tmp_path, "ces_200k")
    out = eval_bed.main([run_dir, "--device", "cpu", "--L", "200", "--M",
                         "4", "--batch-size", "2", "--n-query", "12", "--T",
                         "2", "--L-chunk", "64", "--with-random-baseline"])
    path = os.path.join(run_dir, "eval", "bed_bounds_N12_T2_L200.npz")
    with np.load(path) as f:
        for who in ("aline", "random"):
            pce, nmc = f[f"{who}_pce_mean"], f[f"{who}_nmc_mean"]
            assert pce.shape == (3,) and np.isfinite(pce).all()
            assert (nmc >= pce + np.log(200 / 201) - 1e-5).all()
            np.testing.assert_array_equal(pce, out[f"{who}_pce_mean"])


def test_weights_table_refuses_an_unknown_run(tmp_path):
    run_dir = _run_copy(tmp_path, "hpo_svm_15k", seed=7)
    with pytest.raises(FileNotFoundError, match="banked runs"):
        weights_path(run_dir, "aline")


@pytest.mark.parametrize("entry", ["eval_psychometric", "eval_psi",
                                   "eval_hpo"])
def test_entries_refuse_to_fall_back_to_cpu(tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = "hpo_rpart_15k" if entry == "eval_hpo" else "psych_100k"
    run_dir = _run_copy(tmp_path, run)
    res = subprocess.run(
        [sys.executable, "-m", f"aline_tpu_torch.{entry}", run_dir,
         "--T", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not os.path.exists(os.path.join(run_dir, "eval"))
    shutil.rmtree(run_dir)
