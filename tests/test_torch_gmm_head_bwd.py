"""The port's GMM-head backward (``gmm_head_bwd_plain`` and the
differentiable entry ``gmm_head``) against ``jax.grad`` through the JAX
package's fused head, whose Pallas backward runs in interpret mode as
tests/test_gmm_kernel.py runs it.

Tolerance 1e-4, as tests/test_gmm_kernel.py holds the Pallas backward to
XLA's: the weight gradients sum over every row, in another order in each
framework.  The plain pair is also checked by ``gradcheck`` in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu.ops.gmm_head_kernel import fused_gmm_head
from aline_tpu_torch.ops import _build
from aline_tpu_torch.ops import gmm_head_kernel as ghk

torch.set_num_threads(1)
TOL = 1e-4
NAMES = ("dz", "dw1", "db1", "dw2", "db2")


def _inputs(seed, B, T, D, F=32, C=4):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return ((rng.normal(size=(B, T, D)).astype(f32),
             (rng.normal(size=(C, D, F)) * 0.2).astype(f32),
             (rng.normal(size=(C, F)) * 0.1).astype(f32),
             (rng.normal(size=(C, F, 3)) * 0.2).astype(f32),
             (rng.normal(size=(C, 3)) * 0.1).astype(f32)),
            rng.normal(size=(B, T, C, 3)).astype(f32))


def _jax_grads(arrays, g):
    def loss(*args):
        return jnp.sum(fused_gmm_head(*args, True) * jnp.asarray(g))
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))


@pytest.mark.parametrize("T,D", [(9, 16), (37, 16), (9, 32), (37, 32)])
def test_backward_matches_jax_interpret(T, D):
    arrays, g = _inputs(T * D, 2, T, D)
    want = _jax_grads(arrays, g)
    # the plain backward, as the wrapper runs it for CPU tensors
    z, w1, b1, w2, b2 = map(torch.from_numpy, arrays)
    before = dict(_build.LAUNCHES)
    plain = ghk.gmm_head_bwd(z, w1, b1, w2, torch.from_numpy(g))
    # the autograd entry: forward and backward through the wrappers
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (ghk.gmm_head(*leaves) * torch.from_numpy(g)).sum().backward()
    assert _build.LAUNCHES == before          # CPU tensors launch no kernel
    for name, a, p, w in zip(NAMES, [t.grad for t in leaves], plain, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"autograd {name}")
        np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"plain {name}")


class _PlainPair(torch.autograd.Function):
    """``gmm_head_fwd_plain`` with ``gmm_head_bwd_plain`` as its backward,
    in any dtype (the wrappers take float32 only)."""

    @staticmethod
    def forward(ctx, z, w1, b1, w2, b2):
        ctx.save_for_backward(z, w1, b1, w2)
        return ghk.gmm_head_fwd_plain(z, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return ghk.gmm_head_bwd_plain(*ctx.saved_tensors, g)


def test_plain_backward_gradcheck_f64():
    arrays, _ = _inputs(3, 2, 5, 4, F=6, C=3)
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in arrays]
    assert torch.autograd.gradcheck(_PlainPair.apply, leaves, eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


def test_gmm_head_saves_nothing_without_a_gradient():
    arrays, _ = _inputs(0, 2, 6, 16)
    z, w1, b1, w2, b2 = map(torch.from_numpy, arrays)
    w1.requires_grad_()
    with torch.no_grad():
        out = ghk.gmm_head(z, w1, b1, w2, b2)
    assert out.grad_fn is None
    assert ghk.gmm_head(z, w1, b1, w2, b2).grad_fn is not None


def test_backward_wrapper_rejects_what_the_kernel_does_not_take():
    arrays, g = _inputs(0, 2, 6, 16)
    z, w1, b1, w2, _ = map(torch.from_numpy, arrays)
    g = torch.from_numpy(g)
    with pytest.raises(TypeError):
        ghk.gmm_head_bwd(z, w1, b1, w2, g.double())
    with pytest.raises(ValueError):
        ghk.gmm_head_bwd(z, w1, b1, w2,
                         g.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError):
        ghk.gmm_head_bwd(z, w1, b1, w2, g[:, :, :-1])
