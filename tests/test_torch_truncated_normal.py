"""The port's lower-truncated Normal
(``aline_tpu_torch/distributions/truncated_normal.py``) against the JAX
package's, on the same inputs drawn with numpy: log-density, cdf, icdf
and the sample from given uniform draws (the draws JAX's ``rsample``
takes from its key).

Tolerance: 1e-6 relative, 1e-6 absolute for values near 0 (float32 on
both sides; the erf and erfinv implementations differ in the last bits).
The sample, 1e-5 relative: it is erfinv at 2 u' - 1 close to +-1, whose
condition number there multiplies a last-bit difference of the two erf
implementations (4.3e-06 at most on these draws).  Deep tail: truncated 4 to 6 scales above the mean, where a
millionth of the mass is left.  There the reference's normaliser,
0.5 (1 + erf), rounds to 0 in torch's float32 and to 2 ulps in XLA's, so
neither package's formula means anything; the port takes log Phi from
``log_ndtr`` and is held to float64 instead: 1e-6 relative, 1e-5
absolute (a few float32 ulps of its largest term, z^2 / 2 up to 40).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy import special

from aline_tpu.distributions.truncated_normal import (
    LowerTruncatedNormal as JaxTN,
)
from aline_tpu_torch.distributions.truncated_normal import (
    LowerTruncatedNormal,
)

torch.set_num_threads(1)
RTOL, ATOL = 1e-6, 1e-6


def _params(seed, n, deep):
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=n).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, size=n).astype(np.float32)
    k = rng.uniform(4.0, 6.0, size=n) if deep else rng.uniform(-2, 2, size=n)
    return loc, scale, (loc + scale * k).astype(np.float32)


def _both(loc, scale, trunc):
    return (JaxTN(jnp.asarray(loc), jnp.asarray(scale), jnp.asarray(trunc)),
            LowerTruncatedNormal(torch.from_numpy(loc),
                                 torch.from_numpy(scale),
                                 torch.from_numpy(trunc)))


def _values(trunc, scale, seed):
    rng = np.random.default_rng(seed)
    return ((trunc + scale * rng.uniform(0.0, 3.0, size=trunc.shape))
            .astype(np.float32), rng.uniform(size=trunc.shape)
            .astype(np.float32))


def test_log_prob_cdf_icdf_match_jax():
    loc, scale, trunc = _params(0, 64, deep=False)
    jd, td = _both(loc, scale, trunc)
    value, u = _values(trunc, scale, 1)
    for name, arg in (("log_prob", value), ("cdf", value), ("icdf", u)):
        want = np.asarray(getattr(jd, name)(jnp.asarray(arg)))
        got = getattr(td, name)(torch.from_numpy(arg)).numpy()
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_deep_tail_log_prob_matches_float64():
    loc, scale, trunc = _params(5, 64, deep=True)
    _, td = _both(loc, scale, trunc)
    value, _ = _values(trunc, scale, 6)
    got = td.log_prob(torch.from_numpy(value)).numpy()
    l64, s64, t64, v64 = (a.astype(np.float64)
                          for a in (loc, scale, trunc, value))
    z = (v64 - l64) / s64
    want = (-0.5 * z * z - np.log(s64) - 0.5 * np.log(2 * np.pi)
            - special.log_ndtr((l64 - t64) / s64))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_sample_from_given_draws_matches_jax():
    loc, scale, trunc = _params(2, 32, deep=False)
    jd, td = _both(loc, scale, trunc)
    key = jax.random.key(3)
    want = np.asarray(jd.rsample(key, (5,)))
    u = np.asarray(jax.random.uniform(key, (5, 32), dtype=jnp.float32))
    got = td.sample_from_uniform(torch.from_numpy(u.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    assert (got >= trunc).all()


def test_rsample_stays_above_the_truncation():
    loc, scale, trunc = _params(4, 8, deep=False)
    td = LowerTruncatedNormal(torch.from_numpy(loc), torch.from_numpy(scale),
                              torch.from_numpy(trunc))
    x = td.rsample(torch.Generator().manual_seed(0), (2000,))
    assert x.shape == (2000, 8)
    assert (x >= torch.from_numpy(trunc)).all()
    # the sample's cdf, over the kept mass, is uniform: mean 1/2
    kept = 1.0 - td._normal_cdf(torch.from_numpy(trunc))
    mean_cdf = (td.cdf(x) / kept).mean(0)
    assert torch.allclose(mean_cdf, torch.full((8,), 0.5), atol=0.03)
