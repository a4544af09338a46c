"""The psychometric task (``aline_tpu_torch/tasks/psychometric.py``)
against the JAX package's, on the same inputs drawn with numpy.

Tolerances: the response probability and the Bernoulli log-likelihood
1e-6 relative, 1e-7 absolute (float32 on both sides; 10^z and exp differ
in their last bits).  Where a steep slope sends 10^z past the float32
range, F must be 1 exactly on both sides, and so p = lambda gamma +
(1 - lambda) bit for bit.  The prior by its ranges, means and a KS test
against JAX's draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from aline_tpu import config as jcfg
from aline_tpu.tasks.psychometric import PsychometricTask as JaxPsych
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.psychometric import PsychometricTask

torch.set_num_threads(1)


def _tasks():
    return (JaxPsych(jcfg.parse_overrides(["task=psychometric"]).task),
            build_task(tcfg.parse_overrides(["task=psychometric"]).task))


def _theta(rng, n, beta=(0.1, 2.0)):
    return np.stack([rng.uniform(-3, 3, n), rng.uniform(*beta, n),
                     rng.uniform(0.1, 0.9, n), rng.uniform(0.0, 0.5, n)],
                    axis=-1).astype(np.float32)[..., None]      # [n, 4, 1]


@pytest.mark.parametrize("theta_shape", ["tokens", "flat"])
def test_response_and_log_likelihood_match_jax(theta_shape):
    jt, tt = _tasks()
    assert isinstance(tt, PsychometricTask)
    rng = np.random.default_rng(0)
    n = 3000
    theta = _theta(rng, n)
    if theta_shape == "flat":
        theta = theta[..., 0]
    x = rng.uniform(-5, 5, size=(n, 1)).astype(np.float32)
    p_j = np.asarray(jt.psychometric_function(jnp.asarray(x),
                                              jnp.asarray(theta)))
    p_t = tt.psychometric_function(torch.from_numpy(x),
                                   torch.from_numpy(theta)).numpy()
    assert p_t.shape == p_j.shape == (n, 1)
    np.testing.assert_allclose(p_t, p_j, rtol=1e-6, atol=1e-7)
    y = (rng.uniform(size=(n, 1)) < p_j).astype(np.float32)
    ll_j = np.asarray(jt.log_likelihood(jnp.asarray(y), jnp.asarray(x),
                                        jnp.asarray(theta)))
    ll_t = tt.log_likelihood(torch.from_numpy(y), torch.from_numpy(x),
                             torch.from_numpy(theta)).numpy()
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-6, atol=1e-7)


def test_steep_slope_saturates_to_one_exactly():
    jt, tt = _tasks()
    rng = np.random.default_rng(1)
    n = 500
    theta = _theta(rng, n, beta=(0.1, 0.12))
    theta[:, 0, 0] = -3.0
    x = np.full((n, 1), 5.0, np.float32)        # z >= 66: 10^z = inf
    p_j = np.asarray(jt.psychometric_function(jnp.asarray(x),
                                              jnp.asarray(theta)))
    p_t = tt.psychometric_function(torch.from_numpy(x),
                                   torch.from_numpy(theta)).numpy()
    lam, gam = theta[:, 3], theta[:, 2]
    want = lam * gam + (np.float32(1) - lam)
    np.testing.assert_array_equal(p_t, want)
    np.testing.assert_array_equal(p_j, want)
    # and the far left side of the link: 10^z underflows, F = 0 exactly
    p_t0 = tt.psychometric_function(torch.from_numpy(-x),
                                    torch.from_numpy(theta)).numpy()
    np.testing.assert_array_equal(p_t0, lam * gam)


def test_prior_against_jax():
    jt, tt = _tasks()
    n = 20_000
    th_t = tt.sample_theta(torch.Generator().manual_seed(0), (n,)).numpy()
    th_j = np.asarray(jt.sample_theta(jax.random.key(0), (n,)))
    assert th_t.shape == th_j.shape == (n, 4, 1)
    for k, (lo, hi) in enumerate((tt.ALPHA_RANGE, tt.BETA_RANGE,
                                  tt.GAMMA_RANGE, tt.LAMBDA_RANGE)):
        v = th_t[:, k, 0]
        assert ((v >= lo) & (v <= hi)).all()
        np.testing.assert_allclose(v.mean(), (lo + hi) / 2,
                                   atol=0.02 * (hi - lo))
        assert stats.ks_2samp(v, th_j[:, k, 0]).pvalue > 1e-3, k


def test_sample_batch_layout_and_outcomes():
    jt, tt = _tasks()
    b = tt.sample_batch(torch.Generator().manual_seed(2), 64, n_query=50)
    assert b.x.shape == (64, 51, 1) and b.y.shape == (64, 51, 1)
    assert b.theta.shape == (64, 4, 1) and b.target_all.shape == (64, 4, 1)
    torch.testing.assert_close(b.target_all, b.theta)
    assert ((b.x >= -5) & (b.x <= 5)).all()
    assert set(b.y.unique().tolist()) <= {0.0, 1.0}
    # the outcomes follow p: their mean is p's mean over the batch
    p = tt.psychometric_function(b.x, b.theta[:, None])
    assert abs(float(b.y.mean() - p.mean())) < 0.03
    assert b.ctx_mask[:, :1].all() and not b.ctx_mask[:, 1:].any()
