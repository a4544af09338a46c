"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The machine
with the GPU has no JAX, so run them there without the JAX test conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerance rtol = atol = 1e-4: float32 on both sides with TF32 off; only
the summation order differs.
"""
import pytest
import torch

from aline_tpu_torch.ops import gmm_head_kernel as ghk

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, T, D, F, C, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    return (randn(B, T, D), randn(C, D, F, std=D ** -0.5),
            randn(C, F, std=0.1), randn(C, F, 3, std=F ** -0.5),
            randn(C, 3, std=0.1))


@pytest.mark.parametrize("B,T,D,F,C", [
    (100, 2001, 32, 128, 10),   # the flagship's pool call
    (100, 102, 32, 128, 10),    # the flagship's target call
    (2, 1, 32, 128, 10),        # fewer rows than one block
    (3, 37, 16, 32, 4),         # D=16, ragged rows
    (5, 300, 64, 256, 3),       # D=64, shared memory above 48 KB
    (1, 513, 64, 64, 1),        # one component
    (4, 129, 16, 96, 7),        # F not a power of two
])
def test_gmm_head_kernel_matches_plain(cuda, B, T, D, F, C):
    args = _inputs(B, T, D, F, C)
    before = ghk.LAUNCHES
    got = ghk.gmm_head_fwd(*args)
    torch.cuda.synchronize()
    assert ghk.LAUNCHES == before + 1
    torch.testing.assert_close(got, ghk.gmm_head_fwd_plain(*args),
                               rtol=TOL, atol=TOL)


def test_gmm_head_kernel_empty_input_launches_nothing(cuda):
    args = _inputs(2, 0, 32, 128, 10)
    before = ghk.LAUNCHES
    assert ghk.gmm_head_fwd(*args).shape == (2, 0, 10, 3)
    assert ghk.LAUNCHES == before


def test_gmm_head_kernel_rejects_what_it_does_not_take(cuda):
    z, w1, b1, w2, b2 = _inputs(2, 9, 32, 128, 4)
    with pytest.raises(TypeError):
        ghk.gmm_head_fwd(z.double(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        ghk.gmm_head_fwd(z.cpu(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        ghk.gmm_head_fwd(*_inputs(2, 9, 48, 128, 4))          # D=48
    shifted = torch.empty(z.numel() + 1, device="cuda")[1:].view_as(z)
    shifted.copy_(z)
    with pytest.raises(ValueError, match="aligned"):
        ghk.gmm_head_fwd(shifted, w1, b1, w2, b2)
