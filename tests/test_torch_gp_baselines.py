"""The port's classical GP active-learning baselines
(``aline_tpu_torch.eval.gp_al_baselines``) against
``aline_tpu/eval/gp_al_baselines.py`` on the CPU.

Well-conditioned problems: a smooth function observed with noise of std
0.1 at P ≤ 40 points.  The negative marginal likelihood and its gradient
agree to 1e-4 relative; the posterior and the five deterministic scores
to 1e-4 relative plus 1e-5; the ML-II fit after 80 Adam steps to 1e-3;
the six methods' AL curves to 1e-3, ``random`` fed JAX's uniform draws on
its key schedule (``split(key, B)``, then ``split(k)`` per step).
"""
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu.eval import gp_al_baselines as jgp
from aline_tpu_torch.eval import gp_al_baselines as tgp
from aline_tpu_torch.eval_al import main as eval_al_main

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _problems(seed, B=3, P=24, Nt=10, D=1):
    """x [B, P, D] in [-3, 3], y = a smooth function plus 0.1 noise, and
    held-out targets."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def f(x):
        return np.sin(1.3 * x).sum(-1, keepdims=True) + 0.3 * x[..., :1]

    x = rng.uniform(-3, 3, size=(B, P, D)).astype(f32)
    tx = rng.uniform(-3, 3, size=(B, Nt, D)).astype(f32)
    y = (f(x) + 0.1 * rng.normal(size=(B, P, 1))).astype(f32)
    ty = (f(tx) + 0.1 * rng.normal(size=(B, Nt, 1))).astype(f32)
    mask = rng.random((B, P)) < 0.4
    mask[:, 0] = True
    return x, y, tx, ty, mask


def _params(seed, B, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 0.3, size=(B, D)).astype(np.float32),
            rng.normal(0.0, 0.3, size=B).astype(np.float32),
            rng.normal(np.log(0.1), 0.3, size=B).astype(np.float32))


def _jparams(p):
    return jgp.GPParams(*(jnp.asarray(a) for a in p))


def _tparams(p):
    return tgp.GPParams(*(torch.from_numpy(a) for a in p))


def _rel(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("D", [1, 2])
def test_neg_mll_and_gradient_match_jax(D):
    x, y, _, _, mask = _problems(D, D=D)
    p = _params(10 + D, x.shape[0], D)
    jf = jax.vmap(jax.value_and_grad(jgp._neg_mll))
    want, want_g = jf(_jparams(p), jnp.asarray(x), jnp.asarray(y[..., 0]),
                      jnp.asarray(mask))
    leaves = [t.requires_grad_() for t in _tparams(p)]
    got = tgp._neg_mll(tgp.GPParams(*leaves), torch.from_numpy(x),
                       torch.from_numpy(y[..., 0]), torch.from_numpy(mask))
    grads = torch.autograd.grad(got.sum(), leaves)
    _rel(got.detach(), want, 1e-4, msg="neg_mll")
    for name, g, w in zip(jgp.GPParams._fields, grads, want_g):
        _rel(g, w, 1e-4, 1e-6, msg=name)


def test_posterior_and_scores_match_jax():
    x, y, tx, _, mask = _problems(3, P=30, Nt=12)
    B = x.shape[0]
    p = _params(4, B, 1)
    J = [jnp.asarray(a) for a in (x, y[..., 0], mask, tx)]
    T = [torch.from_numpy(a) for a in (x, y[..., 0], mask, tx)]
    want = jax.vmap(jgp.gp_posterior, (0, 0, 0, 0, 0))(
        _jparams(p), J[0], J[1], J[2], J[3])
    got = tgp.gp_posterior(_tparams(p), T[0], T[1], T[2], T[3])
    for name, g, w in zip(("mean", "var", "noise"), got, want):
        _rel(g, w, 1e-4, 1e-5, msg=name)
    want_cov = jax.vmap(jgp._posterior_cov)(_jparams(p), J[0], J[2], J[3],
                                            J[0])
    _rel(tgp._posterior_cov(_tparams(p), T[0], T[2], T[3], T[0]),
         want_cov, 1e-4, 1e-5, msg="posterior_cov")
    key = jax.random.key(0)
    for name in ("uncertainty", "ucb", "variance_reduction", "epig",
                 "bald"):
        jfn = jgp._ACQ[name]
        want = jax.vmap(lambda pp, X, yy, m, Xt: jfn(pp, X, yy, m, X, Xt,
                                                     key))(
            _jparams(p), J[0], J[1], J[2], J[3])
        got = tgp.acquisition_scores(name, _tparams(p), T[0], T[1], T[2],
                                     T[0], T[3])
        _rel(got, want, 1e-4, 1e-5, msg=name)


def test_fit_gp_matches_jax():
    x, y, _, _, mask = _problems(5, B=4, P=30)
    want = jax.jit(jax.vmap(lambda X, yy, m: jgp.fit_gp(X, yy, m, 80)))(
        jnp.asarray(x), jnp.asarray(y[..., 0]), jnp.asarray(mask))
    got = tgp.fit_gp(torch.from_numpy(x), torch.from_numpy(y[..., 0]),
                     torch.from_numpy(mask), 80)
    for name, g, w in zip(jgp.GPParams._fields, got, want):
        _rel(g, w, 1e-3, 1e-3, msg=name)


def _jax_uniform(key, B, T, P):
    """[T, B, P]: the draws of ``acq_random`` on the keys of JAX's
    ``active_learning_with_gp``."""
    out = np.zeros((T, B, P), np.float32)
    for b, k in enumerate(jax.random.split(key, B)):
        for t in range(T):
            k, k_acq = jax.random.split(k)
            out[t, b] = np.asarray(jax.random.uniform(k_acq, (P,)))
    return out


def test_active_learning_curves_match_jax():
    B, P, T, n_ctx, fit_steps = 3, 20, 3, 2, 20
    x, y, tx, ty, _ = _problems(6, B=B, P=P, Nt=8)
    key = jax.random.key(11)
    want = jgp.compare_acquisition_methods(
        *(jnp.asarray(a) for a in (x, y, tx, ty)), n_ctx, T, key,
        fit_steps=fit_steps)
    uniform = torch.from_numpy(_jax_uniform(key, B, T, P))
    got = tgp.compare_acquisition_methods(
        *(torch.from_numpy(a) for a in (x, y, tx, ty)), n_ctx, T,
        fit_steps=fit_steps, uniform=uniform)
    assert set(got) == set(jgp.ACQUISITION_FUNCTIONS)
    for name in jgp.ACQUISITION_FUNCTIONS:
        for curve in ("rmse", "log_prob"):
            assert got[name][curve].shape == (B, T + 1)
            _rel(got[name][curve], want[name][curve], 1e-3, 1e-3,
                 msg=f"{name} {curve}")
    one = tgp.active_learning_with_gp(
        *(torch.from_numpy(a) for a in (x, y, tx, ty)), n_ctx, T,
        acquisition="bald", fit_steps=fit_steps)
    for curve in ("rmse", "log_prob"):
        torch.testing.assert_close(one[curve], got["bald"][curve],
                                   rtol=1e-5, atol=1e-5)


def test_failed_factorisation_is_nan_without_raising():
    K = torch.eye(3).repeat(2, 1, 1)
    K[1] = -K[1]                                     # not positive definite
    L = tgp._cholesky(K)
    assert torch.isfinite(L[0]).all() and torch.isnan(L[1]).all()


def test_eval_al_writes_the_gp_keys(tmp_path):
    run = tmp_path / "al"
    run.mkdir()
    shutil.copy(ROOT / "checkpoints" / "al1d_200k" / "config.json", run)
    res = eval_al_main([str(run), "--device", "cpu", "--batch-size", "2",
                        "--T", "2", "--n-query", "8",
                        "--with-gp-baselines", "--gp-fit-steps", "4"])
    with np.load(run / "eval" / "al_curves.npz") as saved:
        keys = set(saved.files)
    want = {f"gp_{m}_{c}" for m in jgp.ACQUISITION_FUNCTIONS
            for c in ("log_prob", "rmse")}
    assert want <= keys and want <= set(res)
    for k in want:
        assert res[k].shape == (2, 3) and np.isfinite(res[k]).all(), k
    assert json.loads((run / "config.json").read_text())["task"][
        "n_target_data"] > 0
