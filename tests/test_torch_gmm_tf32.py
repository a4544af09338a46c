"""The arithmetic of the port's GMM-head kernels, emulated in numpy, against
the JAX package's fused head.

``csrc/gmm_head_{fwd,bwd}.cu`` run their three D x F products (the
pre-activation z.W1, dz = dh.W1^T, dW1 = z^T.dh) on the tensor cores as
3xTF32: each float32 operand x is split as x_hi = tf32(x), x_lo =
tf32(x - x_hi), and a.b is summed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with
a float32 accumulator.  ``tf32`` below rounds the low 13 mantissa bits to
nearest, ties away from zero, as ``cvt.rna.tf32.f32`` does.  A product of
two TF32 values is exact in float32, so float32 matmuls of the split parts
emulate the tensor core's products; the rank-3 parts (h.W2, dh's g.W2^T,
dW2, db1, db2) stay float32, as the kernels keep them on FMAs.

The emulation is held to ``fused_gmm_head`` run in interpret mode (and its
VJP), as tests/test_torch_gmm_head{,_bwd}.py run it, at the port's
tolerances: 1e-5 for the forward, 1e-4 for the gradients.  The same inputs
through single-pass TF32 (a_hi.b_hi alone) miss those tolerances: that is
why the kernels split.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aline_tpu.ops.gmm_head_kernel import fused_gmm_head

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
NAMES = ("dz", "dw1", "db1", "dw2", "db2")
# B, T, D, F, C: the flagship's widths, and tests/test_gmm_kernel.py's
SHAPES = [(2, 37, 32, 128, 10), (3, 37, 16, 32, 4)]


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), nearest, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, split_terms=True):
    """a @ b over the last axis of a and the first of b, as the kernels'
    mma.sync computes it: 3xTF32, or single-pass TF32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    hh = np.matmul(a_hi, b_hi, dtype=np.float32)
    if not split_terms:
        return hh
    return hh + (np.matmul(a_lo, b_hi, dtype=np.float32)
                 + np.matmul(a_hi, b_lo, dtype=np.float32))


def emulated_pre(z, w1, b1, split_terms):
    """[rows, C, F]: (b1 + z_hi.w_hi) + (z_lo.w_hi + z_hi.w_lo), the
    order of gmm::pre_tile."""
    out = []
    for c in range(w1.shape[0]):
        z_hi, z_lo = split(z)
        w_hi, w_lo = split(w1[c])
        hh = np.matmul(z_hi, w_hi, dtype=np.float32) + b1[c]
        if split_terms:
            hh = hh + (np.matmul(z_lo, w_hi, dtype=np.float32)
                       + np.matmul(z_hi, w_lo, dtype=np.float32))
        out.append(hh)
    return np.stack(out, axis=1)


def emulated_fwd(z, w1, b1, w2, b2, split_terms=True):
    B, T, D = z.shape
    h = np.maximum(emulated_pre(z.reshape(-1, D), w1, b1, split_terms), 0)
    out = np.einsum("rcf,cfo->rco", h, w2).astype(np.float32) + b2
    return out.reshape(B, T, *out.shape[1:])


def emulated_bwd(z, w1, b1, w2, g, split_terms=True):
    B, T, D = z.shape
    C = w1.shape[0]
    zr = z.reshape(-1, D)
    gr = g.reshape(-1, C, 3)
    pre = emulated_pre(zr, w1, b1, split_terms)
    dh = np.einsum("rco,cfo->rcf", gr, w2).astype(np.float32) * (pre > 0)
    dz = sum(product(dh[:, c], w1[c].T, split_terms) for c in range(C))
    dw1 = np.stack([product(zr.T, dh[:, c], split_terms) for c in range(C)])
    dw2 = np.einsum("rcf,rco->cfo", np.maximum(pre, 0), gr).astype(np.float32)
    return (dz.reshape(B, T, D), dw1, dh.sum(axis=0), dw2, gr.sum(axis=0))


def _inputs(B, T, D, F, C, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return ((rng.normal(size=(B, T, D)).astype(f32),
             (rng.normal(size=(C, D, F)) * D ** -0.5).astype(f32),
             (rng.normal(size=(C, F)) * 0.1).astype(f32),
             (rng.normal(size=(C, F, 3)) * F ** -0.5).astype(f32),
             (rng.normal(size=(C, 3)) * 0.1).astype(f32)),
            rng.normal(size=(B, T, C, 3)).astype(f32))


def _jax_fwd(arrays):
    return np.asarray(fused_gmm_head(*map(jnp.asarray, arrays), True))


def _jax_grads(arrays, g):
    def loss(*args):
        return jnp.sum(fused_gmm_head(*args, True) * jnp.asarray(g))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    return [np.asarray(x) for x in grads]


def _misses(got, want, tol):
    return bool((np.abs(got - want) > tol + tol * np.abs(want)).any())


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                     # TF32's step at 1
    x = np.array([1 + ulp / 4, 1 + ulp * 3 / 4, 1 + ulp / 2, -(1 + ulp / 2),
                  1 + ulp * 3 / 2], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one, one + ulp, one + ulp, -(one + ulp),
                           one + 2 * ulp], np.float32))
    hi, lo = split(np.array([np.pi], np.float32))
    assert abs(float(hi[0]) + float(lo[0]) - np.pi) < 2.0 ** -21 * np.pi


@pytest.mark.parametrize("B,T,D,F,C", SHAPES)
def test_split_forward_matches_jax_interpret(B, T, D, F, C):
    arrays, _ = _inputs(B, T, D, F, C, seed=D + C)
    np.testing.assert_allclose(emulated_fwd(*arrays), _jax_fwd(arrays),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("B,T,D,F,C", SHAPES)
def test_split_backward_matches_jax_vjp(B, T, D, F, C):
    arrays, g = _inputs(B, T, D, F, C, seed=D + C + 1)
    z, w1, b1, w2, _ = arrays
    for name, got, want in zip(NAMES, emulated_bwd(z, w1, b1, w2, g),
                               _jax_grads(arrays, g)):
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("B,T,D,F,C", SHAPES)
def test_single_pass_tf32_misses_the_tolerances(B, T, D, F, C):
    arrays, g = _inputs(B, T, D, F, C, seed=D + C + 2)
    z, w1, b1, w2, _ = arrays
    assert _misses(emulated_fwd(*arrays, split_terms=False),
                   _jax_fwd(arrays), FWD_TOL)
    got = emulated_bwd(z, w1, b1, w2, g, split_terms=False)
    want = _jax_grads(arrays, g)
    # dz and dW1 come from single-pass products; the others only through
    # the relu mask
    assert _misses(got[0], want[0], GRAD_TOL) or \
        _misses(got[1], want[1], GRAD_TOL)
    # ... and on the same inputs the split products stay within them
    assert not _misses(emulated_fwd(*arrays), _jax_fwd(arrays), FWD_TOL)
    for a, b in zip(emulated_bwd(z, w1, b1, w2, g), want):
        assert not _misses(a, b, GRAD_TOL)
