"""The port's active-learning rollout (the slice end to end) against the
JAX package's ``al_rollout_curves``, on JAX-drawn GP batches, at a small
width with random-init parameters and at the flagship's width with its
trained parameters (the committed npz).

Chosen indices must be equal at every step; the log-prob and RMSE curves
agree to atol = rtol = 1e-4 (float32 on both sides, JAX at highest
matmul precision; the difference is summation order).
"""
import dataclasses
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

from aline_tpu import config as jcfg
from aline_tpu.eval.al_curves import al_rollout_curves as jax_rollout
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.tasks.gp import GPTask as JaxGPTask
from aline_tpu.utils.serialization import load_config as jax_load_config
from aline_tpu.utils.serialization import load_config_and_model
from aline_tpu_torch.config import config_from_dict
from aline_tpu_torch.eval.al_curves import al_rollout_curves
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.utils.serialization import (
    AL1D_200K_PARAMS, convert_flax_params, load_model)

torch.set_num_threads(1)
TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_DIR = os.path.join(ROOT, "checkpoints", "al1d_200k")


def _flat(params):
    return {k: np.asarray(v)
            for k, v in flatten_dict(params, sep="/").items()}


def _masked(jbatch, mask):
    """``scripts/eval_al.py --mask``: only the data or theta targets."""
    if mask == "default":
        return jbatch
    sel = np.arange(jbatch.n_target) < jbatch.n_target_data
    return jbatch.replace(
        target_mask=jnp.asarray(sel if mask == "data" else ~sel))


def _check_same_rollout(jmodel, params, model, jbatch, T, strategy):
    want = jax_rollout(jmodel, params, jbatch, T, jax.random.key(1),
                       strategy=strategy)
    got = al_rollout_curves(model, batch_from_numpy(jbatch), T,
                            strategy=strategy)
    np.testing.assert_array_equal(got["idx"].numpy(),
                                  np.asarray(want["idx"]))
    for key in ("log_prob", "rmse"):
        assert got[key].shape == (jbatch.batch_size, T + 1)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


@pytest.fixture(scope="module")
def small():
    cfg = jcfg.Config(dtype="float32")
    cfg.task = jcfg.GPTaskConfig(
        name="AL_mix", dim_x=1, embedding_type="mix", n_context_init=1,
        n_query_init=40, n_target_data=10, n_target_theta=2)
    cfg.encoder = jcfg.EncoderConfig(dim_embedding=16, dim_feedforward=32,
                                     n_head=2, num_layers=2)
    cfg.head = jcfg.HeadConfig(num_components=4)
    jmodel = jax_build_model(cfg)
    jbatch = JaxGPTask(cfg.task).sample_batch(jax.random.key(11), 4,
                                              n_query=40)
    params = jmodel.init(jax.random.key(2), jbatch, training=False)
    model = build_model(config_from_dict(dataclasses.asdict(cfg)), "cpu")
    model.load_state_dict(convert_flax_params(_flat(params), model))
    return jmodel, params, model.eval(), jbatch


@pytest.mark.parametrize("strategy", ["aline", "uncertainty"])
@pytest.mark.parametrize("mask", ["default", "theta"])
def test_small_rollout_matches_jax(small, strategy, mask):
    jmodel, params, model, jbatch = small
    _check_same_rollout(jmodel, params, model, _masked(jbatch, mask), 5,
                        strategy)


def f32_run_copy(run_dir):
    """``run_dir`` (a pathlib.Path) made a copy of the flagship's run
    directory, its config.json only, set to compute in float32."""
    with open(os.path.join(RUN_DIR, "config.json")) as f:
        run_cfg = json.load(f)
    run_cfg["dtype"] = "float32"
    (run_dir / "config.json").write_text(json.dumps(run_cfg))
    return str(run_dir)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The al1d_200k run in float32 in both packages, from the npz (the
    port's through a copy of its config.json set to float32)."""
    cfg = jax_load_config(RUN_DIR)
    cfg.dtype = "float32"
    jmodel = jax_build_model(cfg)
    with np.load(AL1D_200K_PARAMS) as f:
        params = unflatten_dict({k: jnp.asarray(f[k]) for k in f.files},
                                sep="/")
    jbatch = JaxGPTask(cfg.task).sample_batch(jax.random.key(5), 4,
                                              n_query=40)
    run_dir = f32_run_copy(tmp_path_factory.mktemp("al1d_200k_f32"))
    _, model = load_model(run_dir, AL1D_200K_PARAMS, "cpu")
    return jmodel, params, model, jbatch


@pytest.mark.parametrize("strategy", ["aline", "uncertainty"])
def test_flagship_rollout_matches_jax(flagship, strategy):
    jmodel, params, model, jbatch = flagship
    _check_same_rollout(jmodel, params, model, jbatch, 5, strategy)


def test_flagship_data_mask_rollout_matches_jax(flagship):
    jmodel, params, model, jbatch = flagship
    _check_same_rollout(jmodel, params, model, _masked(jbatch, "data"), 3,
                        "aline")


def test_random_strategy_picks_distinct_pool_points(flagship):
    *_, model, jbatch = flagship
    batch = batch_from_numpy(jbatch)
    T = 12
    out = al_rollout_curves(model, batch, T,
                            torch.Generator().manual_seed(0),
                            strategy="random")
    idx = out["idx"]
    assert idx.shape == (batch.batch_size, T)
    n_ctx0 = int(batch.ctx_mask[0].sum())
    assert ((idx >= n_ctx0) & (idx < batch.n_points)).all()
    for row in idx.tolist():
        assert len(set(row)) == T
    assert torch.isfinite(out["log_prob"]).all()


def test_committed_npz_equals_orbax_checkpoint():
    _, _, params = load_config_and_model(RUN_DIR, "aline_al_1d")
    want = _flat(params)
    with np.load(AL1D_200K_PARAMS) as f:
        assert sorted(f.files) == sorted(want)
        for k in f.files:
            assert f[k].dtype == np.float32
            np.testing.assert_array_equal(f[k], want[k], err_msg=k)


def _eval_al(run_dir, *args):
    return subprocess.run(
        [sys.executable, "-m", "aline_tpu_torch.eval_al", run_dir, *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_eval_al_entry_point_on_cpu(tmp_path):
    run_dir = str(tmp_path / "al1d_200k")
    shutil.copytree(RUN_DIR, run_dir)
    res = _eval_al(run_dir, "--device", "cpu", "--batch-size", "2",
                   "--T", "2", "--n-query", "8")
    assert res.returncode == 0, res.stderr
    for name in ("aline", "random", "uncertainty"):
        assert f"[seed 0] {name}: final log_prob " in res.stdout
    curves = np.load(os.path.join(run_dir, "eval", "al_curves.npz"))
    assert curves["aline_log_prob"].shape == (2, 3)
    assert np.isfinite(curves["uncertainty_rmse"]).all()


def test_eval_al_refuses_to_fall_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run_dir = str(tmp_path / "al1d_200k")
    shutil.copytree(RUN_DIR, run_dir)
    res = _eval_al(run_dir, "--batch-size", "2", "--T", "2",
                   "--n-query", "8")
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not os.path.exists(os.path.join(run_dir, "eval"))
