"""The CES task (``aline_tpu_torch/tasks/ces.py``) and its censored
sigmoid-normal (``distributions/censored_sigmoid_normal.py``) against the
JAX package's, on the same inputs drawn with numpy.

Tolerances:

* The censored log-density, 1e-6 relative (of its size, at least 1),
  plus 4 float32 ulps of the sum of its terms' sizes (0.5 z^2, |log v|,
  |log(1 - v)|, |log scale|, and |z| times the sizes z is made of, over
  the scale: the log-density is their sum, and in the deep tail they
  reach 1e4 and cancel), cdf 1e-6 absolute plus 0.4 (the largest normal
  density) times 4 ulps of z's sizes, the sample
  from given normal draws 1e-6 relative and the limits exactly, in both
  tail modes, on cases whose limits sit in the body (|z| <= 1.5), in the
  deep tail (5.5 <= |z| <= 38) and beyond (38 <= |z| <= 200), with values
  at both limits, inside and outside them.  ``tail_mode="reference"``
  reads log(0.5 (1 + erf)) until it underflows: from |z| = 1.5 to 5.42
  the two packages' erf differ in their last bits and 1 + erf keeps ever
  fewer of them, so no such tolerance holds there; from 5.42 on the
  explicit saturation sends both to the same asymptote.
* The utility 1e-6 relative and sigma 1e-6 relative in every rho range
  (measured 1.2e-07 and 3.3e-07).  mu is a difference of two utilities
  times u and cancels: it is held relative to |U(b1)| u, by rho range:
  [0.5, 1] 2e-6, [0.1, 0.5) 5e-6, [0.01, 0.1) 5e-5 (measured 8.8e-07,
  1.7e-06, 1.1e-05: the outer power 1/rho multiplies the sum's rounding).
  The log-likelihood within 1e-5 of max(|ll|, 1) plus what mu's
  tolerance and 4 ulps of logit(y) move it by, (|z| + 1) (tol |U(b1)| u
  + 4 ulp (|log y| + |log(1 - y)|)) / sigma: both enter the z-score over
  sigma, which is small where u is (down to 1e-5), and logit(y) cancels
  for y near 1/2.
* The prior: the port's alpha ~ Dirichlet(1, 1, 1) (normalised
  Exponential(1) draws) by its moments and a two-sample KS test against
  ``jax.random.dirichlet``; rho and log u the same way.
* The sPCE/sNMC bounds of CES histories on given thetas, 1e-4 abs and
  rel, as ``tests/test_torch_eig.py`` holds location finding.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from aline_tpu import config as jcfg
from aline_tpu.distributions.censored_sigmoid_normal import (
    CensoredSigmoidNormal as JaxCSN,
)
from aline_tpu.eval.eig import compute_eig_from_history as jax_eig
from aline_tpu.tasks.ces import CESTask as JaxCES
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.distributions.censored_sigmoid_normal import (
    CensoredSigmoidNormal,
)
from aline_tpu_torch.eval.eig import compute_eig_from_history
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.ces import CESTask

torch.set_num_threads(1)
EPS = np.float32(2.0 ** -22)
UP = np.float32(1.0 - 2.0 ** -22)
LOGIT_UP = float(np.log(np.float64(UP)) - np.log1p(-np.float64(UP)))
# the z-score ranges of the limits: body, deep tail, beyond
Z_CASES = {"body": (0.0, 1.5), "deep": (5.5, 38.0), "beyond": (38.0, 200.0)}
ULP = 2.0 ** -24


def censored_grid(seed, n, case):
    """loc, scale [n, 1] whose lower and upper limits have z-scores in
    the case's range, and values [n, 8]: both limits, four inside, two
    just outside."""
    rng = np.random.default_rng(seed)
    lo, hi = Z_CASES[case]
    if case == "body":
        z_l = rng.uniform(-hi, hi - 0.2, size=n)
        z_u = rng.uniform(z_l + 0.1, hi)
    else:
        z_l = -rng.uniform(lo, hi, size=n)
        z_u = rng.uniform(lo, hi, size=n)
    scale = 2 * LOGIT_UP / (z_u - z_l)
    loc = -LOGIT_UP - z_l * scale
    with np.errstate(over="ignore"):
        inside = 1 / (1 + np.exp(-(loc[:, None] + scale[:, None]
                                   * rng.normal(size=(n, 4)))))
    inside = np.clip(inside, 1e-6, 1 - 1e-6)
    below = np.nextafter(EPS, np.float32(0))
    above = np.nextafter(UP, np.float32(1))
    values = np.concatenate(
        [np.full((n, 1), EPS), np.full((n, 1), UP), inside,
         np.full((n, 1), below), np.full((n, 1), above)], axis=1)
    f32 = np.float32
    return loc[:, None].astype(f32), scale[:, None].astype(f32), \
        values.astype(f32)


def z_error_size(loc, scale, values):
    """The sizes z = (log v - log(1 - v) - loc) / scale is made of, over
    the scale: a rounding of them moves z by ulps of this."""
    v, loc, scale = (a.astype(np.float64) for a in (values, loc, scale))
    with np.errstate(all="ignore"):
        logs = np.abs(np.log(v)) + np.abs(np.log1p(-v))
    return np.nan_to_num((logs + np.abs(loc)) / scale, posinf=0.0)


def term_sizes(loc, scale, values):
    """The sizes of the log-density's terms, in float64: 0.5 z^2, the
    logs, and z times the sizes that make z (a rounding of them moves
    0.5 z^2 by that much)."""
    v, loc, scale = (a.astype(np.float64) for a in (values, loc, scale))
    with np.errstate(all="ignore"):
        logs = np.abs(np.log(v)) + np.abs(np.log1p(-v))
        z = (np.log(v) - np.log1p(-v) - loc) / scale
        return (1 + 0.5 * z * z + np.abs(z) * (logs + np.abs(loc)) / scale
                + logs + np.abs(np.log(scale)))


def _dists(loc, scale, mode):
    return (JaxCSN(jnp.asarray(loc), jnp.asarray(scale), EPS, UP,
                   tail_mode=mode),
            CensoredSigmoidNormal(torch.from_numpy(loc),
                                  torch.from_numpy(scale), float(EPS),
                                  float(UP), tail_mode=mode))


@pytest.mark.parametrize("case", list(Z_CASES))
@pytest.mark.parametrize("mode", ["log_ndtr", "reference"])
def test_censored_log_prob_and_cdf_match_jax(mode, case):
    loc, scale, values = censored_grid(0, 300, case)
    jd, td = _dists(loc, scale, mode)
    want = np.asarray(jd.log_prob(jnp.asarray(values)))
    got = td.log_prob(torch.from_numpy(values)).numpy()
    # outside the limits -inf, at them and inside finite, on both sides
    assert np.isneginf(want[:, 6:]).all() and np.isneginf(got[:, 6:]).all()
    assert np.isfinite(got[:, :6]).all()
    tol = (1e-6 * np.maximum(np.abs(want[:, :6]), 1)
           + 4 * ULP * term_sizes(loc, scale, values[:, :6]))
    err = np.abs(got[:, :6] - want[:, :6])
    assert (err <= tol).all(), f"worst {(err / tol).max()} of tolerance"
    # the cdf moves by at most 0.4 times z's error
    cdf_tol = 1e-6 + 0.4 * 4 * ULP * z_error_size(loc, scale, values)
    cdf_err = np.abs(td.cdf(torch.from_numpy(values)).numpy()
                     - np.asarray(jd.cdf(jnp.asarray(values))))
    assert (cdf_err <= cdf_tol).all()


@pytest.mark.parametrize("case", list(Z_CASES))
def test_censored_tail_modes_agree_in_the_body_only(case):
    loc, scale, values = censored_grid(1, 200, case)
    a = CensoredSigmoidNormal(torch.from_numpy(loc), torch.from_numpy(scale),
                              float(EPS), float(UP))
    b = CensoredSigmoidNormal(torch.from_numpy(loc), torch.from_numpy(scale),
                              float(EPS), float(UP), tail_mode="reference")
    la, lb = (d.log_prob(torch.from_numpy(values))[:, :2] for d in (a, b))
    if case == "body":
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-5)
    else:
        # the reference's asymptote overestimates the deep-tail log-mass
        assert (lb > la).all()


def test_censored_sample_from_given_draws_matches_jax():
    loc, scale, _ = censored_grid(2, 50, "body")
    loc = loc * 0.1      # many draws land inside, some beyond a limit
    jd, td = _dists(loc, scale, "log_ndtr")
    key = jax.random.key(4)
    want = np.asarray(jd.rsample(key, (40,)))
    eps = np.asarray(jax.random.normal(key, (40,) + loc.shape,
                                       dtype=jnp.float32))
    got = td.sample_from_normal(torch.from_numpy(eps.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    at_limit = (want == EPS) | (want == UP)
    assert 0 < at_limit.mean() < 1
    np.testing.assert_array_equal(got[at_limit], want[at_limit])


def test_clamp_gives_the_limits_exactly():
    td = CensoredSigmoidNormal(torch.zeros(4, 1), torch.ones(4, 1),
                               float(EPS), float(UP))
    eps = torch.tensor([[-1e4], [-40.0], [40.0], [1e4]])
    x = td.sample_from_normal(eps)
    assert x.dtype == torch.float32
    assert (x[:2] == torch.tensor(EPS)).all()
    assert (x[2:] == torch.tensor(UP)).all()
    # a sample at a limit takes the limit's log-mass, log Phi(-|z|)
    lp = td.log_prob(x)
    want = torch.special.log_ndtr(-torch.tensor(LOGIT_UP)).float()
    torch.testing.assert_close(lp, want.expand(4, 1), rtol=1e-6, atol=0)


def test_refuses_an_unknown_tail_mode():
    with pytest.raises(ValueError, match="tail_mode"):
        CensoredSigmoidNormal(torch.zeros(1), torch.ones(1), 0.1, 0.9,
                              tail_mode="exact")


# -- the task -----------------------------------------------------------------

def _tasks(*extra):
    args = ["task=ces", *extra]
    return (JaxCES(jcfg.parse_overrides(args).task),
            build_task(tcfg.parse_overrides(args).task))


def _thetas(rng, n, rho_range):
    rho = rng.uniform(*rho_range, size=n)
    alpha = rng.dirichlet(np.ones(3), size=n)
    log_u = rng.normal(1.0, 3.0, size=n)
    return np.concatenate([rho[:, None], alpha, log_u[:, None]],
                          axis=-1).astype(np.float32)


RHO_CASES = {(0.5, 1.0): 2e-6, (0.1, 0.5): 5e-6, (0.01, 0.1): 5e-5}


@pytest.mark.parametrize("rho_range", list(RHO_CASES), ids=str)
def test_response_and_log_likelihood_match_jax(rho_range):
    jt, tt = _tasks()
    assert isinstance(tt, CESTask)
    rng = np.random.default_rng(5)
    n = 2000
    theta = _thetas(rng, n, rho_range)
    xi = rng.uniform(0.0, 100.0, size=(n, 6)).astype(np.float32)
    j_in = [jnp.asarray(a) for a in (xi, theta)]
    t_in = [torch.from_numpy(a) for a in (xi, theta)]
    u_j = np.asarray(JaxCES.utility(j_in[0][:, :3], j_in[1][:, :1],
                                    j_in[1][:, 1:4]))
    u_t = CESTask.utility(t_in[0][:, :3], t_in[1][:, :1],
                          t_in[1][:, 1:4]).numpy()
    np.testing.assert_allclose(u_t, u_j, rtol=1e-6, atol=0)
    mu_j, sig_j = (np.asarray(v) for v in jt._response_params(*j_in))
    mu_t, sig_t = (v.numpy() for v in tt._response_params(*t_in))
    np.testing.assert_allclose(sig_t, sig_j, rtol=1e-6, atol=0)
    scale = np.abs(u_j) * np.exp(theta[:, 4:5])
    tol = RHO_CASES[rho_range]
    assert (np.abs(mu_t - mu_j) <= tol * scale).all()
    y = np.asarray(jt.simulate(jax.random.key(6), *j_in))
    ll_j = np.asarray(jt.log_likelihood(jnp.asarray(y), *j_in))
    ll_t = tt.log_likelihood(torch.from_numpy(y.copy()), *t_in).numpy()
    assert np.isfinite(ll_t).all() and np.isfinite(ll_j).all()
    y64 = y.astype(np.float64)
    logs = np.abs(np.log(y64)) + np.abs(np.log1p(-y64))
    z = (np.log(y64) - np.log1p(-y64) - mu_j) / sig_j
    bound = (1e-5 * np.maximum(np.abs(ll_j), 1)
             + (np.abs(z) + 1) * (tol * scale + 4 * ULP * logs) / sig_j)
    assert (np.abs(ll_t - ll_j) <= bound).all()


def test_prior_moments_and_ks_against_jax():
    jt, tt = _tasks()
    n = 40_000
    th_t = tt.sample_theta(torch.Generator().manual_seed(0), (n,)).numpy()
    th_j = np.asarray(jt.sample_theta(jax.random.key(0), (n,)))
    assert th_t.shape == th_j.shape == (n, 5)
    alpha = th_t[:, 1:4]
    np.testing.assert_allclose(alpha.sum(-1), 1.0, rtol=1e-6)
    assert (alpha > 0).all()
    # Dirichlet(1,1,1): mean 1/3, variance (1/3)(2/3)/4 = 1/18 each,
    # covariance -1/36
    np.testing.assert_allclose(alpha.mean(0), 1 / 3, atol=5e-3)
    np.testing.assert_allclose(alpha.var(0), 1 / 18, atol=2e-3)
    np.testing.assert_allclose(np.cov(alpha.T)[0, 1], -1 / 36, atol=2e-3)
    assert ((th_t[:, 0] >= 0.01) & (th_t[:, 0] <= 1.0)).all()
    np.testing.assert_allclose(th_t[:, 4].mean(), 1.0, atol=0.05)
    np.testing.assert_allclose(th_t[:, 4].std(), 3.0, atol=0.05)
    for k in range(5):
        p = stats.ks_2samp(th_t[:, k], th_j[:, k]).pvalue
        assert p > 1e-3, (k, p)


def test_sample_batch_layout():
    _, tt = _tasks()
    b = tt.sample_batch(torch.Generator().manual_seed(1), 3, n_query=7)
    assert b.x.shape == (3, 8, 6) and b.y.shape == (3, 8, 1)
    assert b.theta.shape == (3, 5) and b.target_all.shape == (3, 5, 1)
    torch.testing.assert_close(b.target_all[..., 0], b.theta)
    assert ((b.x >= 0) & (b.x <= 100)).all()
    assert ((b.y >= float(EPS)) & (b.y <= float(UP))).all()
    assert b.ctx_mask[:, :1].all() and not b.ctx_mask[:, 1:].any()
    assert b.target_x.shape == (3, 0, 6)


# -- the bounds on given thetas ------------------------------------------

def _histories(seed, B, Th, L):
    rng = np.random.default_rng(seed)
    theta_0 = _thetas(rng, B, (0.01, 1.0))
    x = rng.uniform(0.0, 100.0, size=(B, Th, 6)).astype(np.float32)
    jt, _ = _tasks()
    y = np.asarray(jt.simulate(jax.random.key(seed), jnp.asarray(x),
                               jnp.asarray(theta_0)[:, None]))
    thetas = _thetas(rng, L * B, (0.01, 1.0)).reshape(L, B, 5)
    return theta_0, x, y, thetas


@pytest.mark.parametrize("stepwise", [False, True])
def test_bounds_on_given_thetas_match_jax(stepwise):
    B, Th, L, L_chunk = 3, 5, 500, 64
    jt, tt = _tasks()
    theta_0, x, y, thetas = _histories(7, B, Th, L)
    want = jax_eig(jt, jnp.asarray(theta_0), jnp.asarray(x), jnp.asarray(y),
                   L, jax.random.key(0), L_chunk=L_chunk, stepwise=stepwise,
                   thetas=jnp.asarray(thetas))
    got = compute_eig_from_history(
        tt, *(torch.from_numpy(a.copy()) for a in (theta_0, x, y)), L,
        seed=0, L_chunk=L_chunk, stepwise=stepwise,
        thetas=torch.from_numpy(thetas))
    for g, w, name in zip(got, want, ("pce", "nmc")):
        assert g.shape == ((B, Th) if stepwise else (B,))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    pce, nmc = got
    assert (nmc - pce >= math.log(L / (L + 1)) - 1e-5).all()
