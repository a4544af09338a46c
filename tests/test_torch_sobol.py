"""The port's Sobol and lattice designs (``aline_tpu_torch.ops.sobol``,
``tasks/gp.py`` ``data_gen``) and the MLE losses
(``aline_tpu_torch.eval.mle_losses``) against the JAX package's.

The unscrambled sequence is bitwise JAX's for n ≤ 4096, dim ≤ 16; the
scrambled and lattice designs are bitwise JAX's given JAX's shifts and
permutations (drawn here on its key schedule); the losses agree to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu.distributions.gmm import normal_log_prob as j_normal_log_prob
from aline_tpu.eval import mle_losses as jmle
from aline_tpu.ops import sobol as jsobol
from aline_tpu.tasks.gp import GPTask as JaxGPTask
from aline_tpu_torch.config import GPTaskConfig
from aline_tpu_torch.distributions.gmm import normal_log_prob
from aline_tpu_torch.eval import mle_losses as tmle
from aline_tpu_torch.ops import sobol as tsobol
from aline_tpu_torch.tasks.gp import GPTask

torch.set_num_threads(1)


def _equal(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), msg)


@pytest.mark.parametrize("n,dim", [(4096, 16), (1000, 3), (1, 1), (37, 2)])
def test_sobol_base_is_bitwise_jax(n, dim):
    _equal(tsobol.sobol_base(n, dim), jsobol.sobol_base(n, dim))


def _jax_sobol_draws(key, B, n, dim):
    """The shift and permutations ``sample_sobol`` draws from ``key``."""
    k_shift, k_perm = jax.random.split(key)
    shift = jax.random.bits(k_shift, (B, 1, dim), jnp.uint32) & jnp.uint32(
        (1 << 30) - 1)
    perms = jax.vmap(lambda k: jax.random.permutation(k, n))(
        jax.random.split(k_perm, B * dim)).reshape(B, dim, n)
    return (torch.from_numpy(np.asarray(shift).astype(np.int64)),
            torch.from_numpy(np.asarray(perms).astype(np.int64)))


@pytest.mark.parametrize("B,n,dim", [(3, 50, 2), (2, 257, 5)])
def test_scrambled_sobol_is_bitwise_jax(B, n, dim):
    key = jax.random.key(n)
    want = jsobol.sample_sobol(key, B, n, dim)
    shift, perms = _jax_sobol_draws(key, B, n, dim)
    got = tsobol.scrambled_points(tsobol.sobol_base(n, dim), shift, perms)
    _equal(got, want)
    # the GP task's designs in its box
    cfg = dict(name="AL", dim_x=dim, embedding_type="data",
               n_target_data=4, design_scale=2.5)
    jt = JaxGPTask(_jax_gp_cfg(cfg))
    tt = GPTask(GPTaskConfig(**cfg, data_gen="sobol"))
    _equal(tt._to_box(got), jt.sample_data_sobol(key, B, n))
    draw = tt.sample_data_sobol(torch.Generator().manual_seed(0), B, n)
    assert draw.shape == (B, n, dim) and (draw.abs() <= 2.5).all()
    # every dimension of a scrambled row is a permutation of the shifted
    # base: its sorted values are the sorted shifted points
    assert torch.equal(torch.sort(got, dim=1).values,
                       torch.sort(tsobol.scrambled_points(
                           tsobol.sobol_base(n, dim), shift,
                           torch.arange(n).expand(B, dim, n)), dim=1).values)


def _jax_gp_cfg(cfg):
    from aline_tpu import config as jcfg
    return jcfg.GPTaskConfig(**cfg)


@pytest.mark.parametrize("B,n,dim", [(3, 40, 1), (2, 65, 3)])
def test_lattice_is_bitwise_jax(B, n, dim):
    cfg = dict(name="AL", dim_x=dim, embedding_type="data",
               n_target_data=4, design_scale=5.0)
    jt = JaxGPTask(_jax_gp_cfg(cfg))
    tt = GPTask(GPTaskConfig(**cfg, data_gen="lattice"))
    key = jax.random.key(dim)
    want = jt.sample_data_lattice(key, B, n)
    k_shift, k_perm = jax.random.split(key)
    shift = jax.random.uniform(k_shift, (B, 1, dim))
    perms = jnp.stack([jax.random.permutation(k, n) for k in
                       jax.random.split(k_perm, B * dim)]).reshape(B, dim, n)
    got = tt.lattice_points(n, torch.from_numpy(np.array(shift)),
                            torch.from_numpy(np.asarray(perms)
                                             .astype(np.int64)))
    _equal(got, want)
    draw = tt.sample_batch(torch.Generator().manual_seed(1), B, 10)
    assert (draw.x.abs() <= 5.0).all()


def _normal_params(seed, B=4, K=3, D=2):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    loc = rng.normal(size=(B, K, D)).astype(f32)
    scale = rng.uniform(0.3, 1.5, size=(B, K, D)).astype(f32)
    target = rng.normal(size=(B, K, D)).astype(f32)
    return loc, scale, target


@pytest.mark.parametrize("reduction", ["mean", "sum", "logsumexp", "none"])
def test_mle_losses_match_jax(reduction):
    loc, scale, target = _normal_params(0)
    J = [jnp.asarray(a) for a in (loc, scale, target)]
    T = [torch.from_numpy(a) for a in (loc, scale, target)]

    def close(got, want, name):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)

    close(tmle.nmle_loss(lambda v: normal_log_prob(v, T[0], T[1]), T[2],
                         reduction),
          jmle.nmle_loss(lambda v: j_normal_log_prob(v, J[0], J[1]), J[2],
                         reduction), "nmle")
    close(tmle.sorted_nmle_loss(*T, reduction),
          jmle.sorted_nmle_loss(*J, reduction), "sorted")
    close(tmle.chamfer_nmle_loss(*T, reduction),
          jmle.chamfer_nmle_loss(*J, reduction), "chamfer")
    close(tmle.set_nmle_loss(*T, reduction), jmle.set_nmle_loss(*J, reduction),
          "set")
    key = jax.random.key(4)
    N = 50
    eps = np.asarray(jax.random.normal(key, (N,) + loc.shape))
    close(tmle.l2_distance(None, *T, N=N, reduction=reduction,
                           eps=torch.from_numpy(eps)),
          jmle.l2_distance(key, *J, N=N, reduction=reduction), "l2")
    drawn = tmle.l2_distance(torch.Generator().manual_seed(0), *T, N=N)
    assert torch.isfinite(drawn)
