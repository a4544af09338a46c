"""The port's GMM head (aline_tpu_torch.ops.gmm_head_kernel and
models.heads.GMMTargetHead) against the JAX package's fused GMM head.

On the CPU the port's wrapper runs its plain version; JAX's fused head
runs its Pallas kernel in interpret mode, as tests/test_gmm_kernel.py
runs it.  Tolerance 1e-5: both are float32 with highest matmul precision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu.models.heads import GMMTargetHead as JaxGMMTargetHead
from aline_tpu.ops.gmm_head_kernel import fused_gmm_head
from aline_tpu_torch.models.heads import GMMTargetHead
from aline_tpu_torch.ops import _build
from aline_tpu_torch.ops import gmm_head_kernel as ghk

torch.set_num_threads(1)
TOL = 1e-5


def _inputs(seed, B, T, D, F, C):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(B, T, D)).astype(f32),
            (rng.normal(size=(C, D, F)) * 0.2).astype(f32),
            (rng.normal(size=(C, F)) * 0.1).astype(f32),
            (rng.normal(size=(C, F, 3)) * 0.2).astype(f32),
            (rng.normal(size=(C, 3)) * 0.1).astype(f32))


@pytest.mark.parametrize("B,T,D,F,C", [
    (3, 11, 16, 32, 4),      # tests/test_gmm_kernel.py's shape
    (2, 37, 16, 32, 4),      # ragged T
    (2, 5, 32, 128, 10),     # the flagship's D, F, C
])
def test_plain_matches_jax_fused_kernel(B, T, D, F, C):
    arrays = _inputs(B * T, B, T, D, F, C)
    want = fused_gmm_head(*map(jnp.asarray, arrays), True)
    before = dict(_build.LAUNCHES)
    got = ghk.gmm_head_fwd(*map(torch.from_numpy, arrays))
    assert _build.LAUNCHES == before          # CPU tensors launch no kernel
    assert got.shape == (B, T, C, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_head_module_matches_jax(fused):
    D, F, C = 16, 32, 4
    z = np.random.default_rng(1).normal(size=(2, 7, D)).astype(np.float32)
    head = JaxGMMTargetHead(dim_y=1, dim_embedding=D, dim_feedforward=F,
                            num_components=C, fused=fused)
    params = head.init(jax.random.key(0), jnp.asarray(z))
    want = head.apply(params, jnp.asarray(z))
    port = GMMTargetHead(D, F, C, std_min=1e-4)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in params["params"].items()})
    with torch.no_grad():
        got = port(torch.from_numpy(z))
    for name in ("mixture_means", "mixture_stds", "mixture_weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_wrapper_rejects_f64_and_non_contiguous():
    z, w1, b1, w2, b2 = map(torch.from_numpy, _inputs(0, 2, 6, 16, 32, 4))
    with pytest.raises(TypeError):
        ghk.gmm_head_fwd(z.double(), w1, b1, w2, b2)
    with pytest.raises(TypeError):
        ghk.gmm_head_fwd(z, w1.double(), b1, w2, b2)
    with pytest.raises(ValueError):
        ghk.gmm_head_fwd(z.transpose(0, 1), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        ghk.gmm_head_fwd(z, w1.transpose(1, 2).contiguous()
                         .transpose(1, 2), b1, w2, b2)
    with pytest.raises(ValueError):
        ghk.gmm_head_fwd(z, w1, b1[:, :-1], w2, b2)
