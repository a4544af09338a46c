"""The port's GP task (aline_tpu_torch.tasks.gp) against the JAX package's.

Both packages get the same x, θ, kernel index and normals (JAX draws
them, from the same keys as its ``generate_gp_data``); covariance,
Cholesky factor and outcomes agree to 1e-4, float32 on both sides.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu import config as jcfg
from aline_tpu.tasks.gp import GPTask as JaxGPTask
from aline_tpu_torch.config import GPTaskConfig
from aline_tpu_torch.tasks.gp import GPTask, cholesky_with_retry

torch.set_num_threads(1)
TOL = 1e-4


def _cfgs(**kw):
    base = dict(name="AL_mix", dim_x=1, embedding_type="mix",
                n_context_init=1, n_query_init=20, n_target_data=8,
                n_target_theta=2)
    base.update(kw)
    return jcfg.GPTaskConfig(**base), GPTaskConfig(**base)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_draws(key, B, N, weights):
    """The kernel index and normals ``generate_gp_data`` draws from key."""
    k_kernel, k_f, k_noise = jax.random.split(key, 3)
    kernel_idx = jax.random.categorical(
        k_kernel, jnp.log(weights + 1e-38), shape=(B,))
    return (kernel_idx, jax.random.normal(k_f, (B, N, 1)),
            jax.random.normal(k_noise, (B, N, 1)))


def _jax_problem(jtask, seed, B, N):
    k_th, k_x, k_y = jax.random.split(jax.random.key(seed), 3)
    return (jtask.sample_theta(k_th, (B,)), jtask.sample_data(k_x, B, N),
            k_y)


# every kernel type the prior can pick (matern12 has weight 0)
KERNEL_IDX = jnp.asarray([0, 2, 3, 0, 2, 3], jnp.int32)


@pytest.mark.parametrize("dim_x", [1, 2])
def test_covariance_matches_jax(dim_x):
    """At the prior's real conditioning: 30 points, where the 1-D
    covariances have condition numbers near 1e9.  The factors of such
    matrices differ between two float32 Cholesky implementations by more
    than 1e-4, so here each side's factor is checked to reproduce
    K + jitter·I, and the factors themselves are compared below."""
    jc, tc = _cfgs(dim_x=dim_x, n_target_theta=dim_x + 1)
    jtask, task = JaxGPTask(jc), GPTask(tc)
    B, N = 6, 30
    theta, x, _ = _jax_problem(jtask, dim_x, B, N)
    K_j = jtask._covariance(x, theta, KERNEL_IDX)
    K_t = task._covariance(_t(x), _t(theta), _t(KERNEL_IDX).long())
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j),
                               rtol=TOL, atol=TOL)
    L_t = cholesky_with_retry(K_t, task.jitter)
    np.testing.assert_allclose(
        (L_t @ L_t.transpose(1, 2)).numpy(),
        K_t.numpy() + task.jitter * np.eye(N, dtype=np.float32),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cholesky_and_outcomes_match_jax(seed):
    """Factors and outcomes at 10 points in 2-D, where the covariances
    are well enough conditioned for two float32 factorizations to agree."""
    jc, tc = _cfgs(dim_x=2, n_target_theta=3)
    jtask, task = JaxGPTask(jc), GPTask(tc)
    B, N = 6, 10
    theta, x, k_y = _jax_problem(jtask, seed, B, N)
    K_j = jtask._covariance(x, theta, KERNEL_IDX)
    L_j = jnp.linalg.cholesky(K_j + jtask.jitter * jnp.eye(N))
    L_t = cholesky_with_retry(_t(K_j), task.jitter)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j),
                               rtol=TOL, atol=TOL)
    # outcomes: JAX draws inside generate_gp_data from k_y
    y_j = jtask.generate_gp_data(k_y, x, theta)
    drawn_idx, eps_f, eps_noise = _jax_draws(k_y, B, N,
                                             jtask.kernel_weights)
    y_t = task.gp_outcomes(_t(x), _t(theta), _t(drawn_idx).long(),
                           _t(eps_f), _t(eps_noise))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               rtol=TOL, atol=TOL)


def test_cholesky_retry_matches_jax():
    """Row 1 is indefinite at 1e-5 jitter but positive definite at 1e-3:
    both packages factor it on the retry."""
    N = 6
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    good = Q @ np.diag(np.linspace(0.1, 1.0, N)) @ Q.T
    bad = Q @ np.diag([-2e-4, 0.2, 0.4, 0.6, 0.8, 1.0]) @ Q.T
    K = np.stack([good, bad]).astype(np.float32)
    jc, tc = _cfgs()
    jtask, task = JaxGPTask(jc), GPTask(tc)
    eye = np.eye(N, dtype=np.float32)
    assert torch.linalg.cholesky_ex(_t(K + task.jitter * eye))[1][1] != 0
    L_t = cholesky_with_retry(_t(K), task.jitter)
    assert torch.isfinite(L_t).all()
    np.testing.assert_allclose(
        L_t[1].numpy(), np.linalg.cholesky(K[1] + 1e-3 * eye),
        rtol=TOL, atol=TOL)
    # JAX's retry, through generate_gp_data with this covariance
    key = jax.random.key(3)
    x = jnp.zeros((2, N, 1))
    theta = jnp.ones((2, 2, 1))
    jtask._covariance = lambda *a: jnp.asarray(K)
    y_j = jtask.generate_gp_data(key, x, theta)
    kernel_idx, eps_f, eps_noise = _jax_draws(key, 2, N,
                                              jtask.kernel_weights)
    task._covariance = lambda *a: _t(K)
    y_t = task.gp_outcomes(_t(x), _t(theta), _t(kernel_idx).long(),
                           _t(eps_f), _t(eps_noise))
    assert np.isfinite(np.asarray(y_j)).all()
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dim_x", [1, 2])
def test_sample_batch_shapes_and_ranges(dim_x):
    _, tc = _cfgs(dim_x=dim_x, n_target_theta=dim_x + 1)
    task = GPTask(tc)
    B, n_query = 64, 15
    b = task.sample_batch(torch.Generator().manual_seed(dim_x), B,
                          n_query=n_query)
    P = tc.n_context_init + n_query
    assert b.x.shape == (B, P, dim_x) and b.y.shape == (B, P, 1)
    assert b.target_x.shape == (B, tc.n_target_data, dim_x)
    assert b.target_all.shape == (B, tc.n_target_data + dim_x + 1, 1)
    assert b.theta.shape == (B, dim_x + 1, 1)
    assert b.ctx_mask.sum(1).eq(tc.n_context_init).all()
    assert bool(b.target_mask.all())
    assert torch.isfinite(b.y).all() and torch.isfinite(b.target_all).all()
    scale = tc.design_scale
    assert (b.x.abs() <= scale).all() and (b.target_x.abs() <= scale).all()
    ls, out_scale = b.theta[:, :dim_x, 0], b.theta[:, dim_x, 0]
    lo, hi = 0.1 * math.sqrt(dim_x), 2.0 * math.sqrt(dim_x)
    assert ((ls >= lo) & (ls <= hi)).all()
    assert ((out_scale >= 0.1) & (out_scale <= 1.0)).all()
    # theta targets are the theta values
    torch.testing.assert_close(b.target_all[:, tc.n_target_data:], b.theta)


def test_unported_design_generators_raise():
    """Sobol and lattice designs are ported (``tests/test_torch_sobol.py``
    holds them to JAX's); an unknown generator still raises."""
    for gen in ("sobol", "lattice"):
        task = GPTask(_cfgs(data_gen=gen)[1])
        b = task.sample_batch(torch.Generator().manual_seed(0), 3, 20)
        scale = task.design_scale
        assert (b.x.abs() <= scale).all() and torch.isfinite(b.y).all()
    with pytest.raises(ValueError, match="data_gen"):
        GPTask(_cfgs(data_gen="halton")[1])
