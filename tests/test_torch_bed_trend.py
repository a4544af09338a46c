"""The port's bounds-against-L trend (``aline_tpu_torch.eval_bed_trend``,
``eval/eig.py`` ``compute_eig_from_history(L_checkpoints=...)``) against
the JAX package's on the CPU.

On given thetas (JAX's chunk draws, ``fold_in(key, i)`` per chunk) the
trend equals JAX's ``compute_eig_from_history(L_checkpoints=...)``
within 1e-4; on the port's own draws its last row equals the direct call
bit for bit, and ``eval_bed_trend``'s rows equal ``eval_eig_from_history``
of the same traces at the largest L.
"""
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu import config as jcfg
from aline_tpu.eval.eig import compute_eig_from_history as j_eig
from aline_tpu.tasks import build_task as jax_build_task
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.eval.eig import (
    compute_eig_from_history,
    derive_seed,
    eval_eig_from_history,
)
from aline_tpu_torch.eval_bed_trend import bounds_trend
from aline_tpu_torch.eval_bed_trend import main as trend_main
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.utils.serialization import load_model, weights_path

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
LS = [40, 100, 250]


def _traces(seed, B=3, Th=5):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.uniform(size=(B, 1, 2)).astype(f32),
            rng.uniform(size=(B, Th, 2)).astype(f32),
            rng.normal(size=(B, Th, 1)).astype(f32))


@pytest.mark.parametrize("stepwise", [False, True])
def test_trend_on_given_thetas_matches_jax(stepwise):
    args = ["task=location_finding"]
    jt = jax_build_task(jcfg.parse_overrides(args).task)
    tt = build_task(tcfg.parse_overrides(args).task)
    theta0, x, y = _traces(0)
    B, Lc = x.shape[0], 32
    key = jax.random.key(7)
    want = j_eig(jt, jnp.asarray(theta0), jnp.asarray(x), jnp.asarray(y),
                 max(LS), key, L_chunk=Lc, stepwise=stepwise,
                 L_checkpoints=LS)
    n_chunks = -(-max(LS) // Lc)
    thetas = np.concatenate([np.asarray(jt.sample_theta(
        jax.random.fold_in(key, i), (Lc, B))) for i in range(n_chunks)])
    got = compute_eig_from_history(
        tt, *(torch.from_numpy(a) for a in (theta0, x, y)), 0, 0,
        L_chunk=Lc, stepwise=stepwise,
        thetas=torch.from_numpy(thetas[:max(LS)]), L_checkpoints=LS)
    assert sorted(got) == sorted(want) == [64, 128, 250]
    for L_eff in want:
        for g, w in zip(got[L_eff], want[L_eff]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4, err_msg=str(L_eff))


def test_last_row_is_the_direct_call_bit_for_bit():
    tt = build_task(tcfg.parse_overrides(["task=location_finding"]).task)
    T_ = [torch.from_numpy(a) for a in _traces(1)]
    trend = compute_eig_from_history(tt, *T_, 1000, 5, L_chunk=64,
                                     stepwise=True, L_checkpoints=[100, 500])
    direct = compute_eig_from_history(tt, *T_, 1000, 5, L_chunk=64,
                                      stepwise=True)
    assert sorted(trend) == [128, 512, 1000]
    for g, w in zip(trend[1000], direct):
        assert torch.equal(g, w)


def test_eval_bed_trend_equals_eval_eig_from_history(tmp_path):
    run = tmp_path / "loc"
    run.mkdir()
    shutil.copy(ROOT / "checkpoints" / "loc_100k" / "config.json", run)
    argv = [str(run), "--device", "cpu", "--L-checkpoints", "50,400",
            "--M", "4", "--batch-size", "2", "--n-query", "20", "--T", "3",
            "--seed", "3", "--L-chunk", "64"]
    results = trend_main(argv)
    assert sorted(results) == ["L400_nmc", "L400_pce", "L64_nmc", "L64_pce"]
    with np.load(run / "eval" / "bounds_trend_M4_T3.npz") as saved:
        for k in results:
            np.testing.assert_array_equal(saved[k], results[k])
    cfg, model = load_model(str(run), weights_path(str(run), "aline"), "cpu")
    task = build_task(cfg.task)
    rows, (theta, x, y) = bounds_trend(model, task, 3, [50, 400], 4, 2, 3,
                                       n_query=20, L_chunk=64)
    want = eval_eig_from_history(task, theta, x, y, 400,
                                 derive_seed(3, 1), batch_size=2,
                                 err_type="std", L_chunk=64)
    pce, nmc = rows[400]
    np.testing.assert_array_equal(pce, results["L400_pce"])
    assert pce.mean() == want["pce_mean"] and nmc.mean() == want["nmc_mean"]
    assert (nmc >= pce - 1e-5).all()
