"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The machine
with the GPU has no JAX, so run them there without the JAX test conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerance rtol = atol = 1e-4: float32 on both sides with TF32 off; only
the summation order differs (the backward's weight gradients sum every
row, in per-block partials and then over blocks).
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


def _inputs(B, T, D, F, C, seed=0, grid=False):
    """``grid``: z, W1 and b1 on a dyadic grid, so that every
    pre-activation is exact in any summation order and the relu mask of
    the backward is the same in the kernel and in the plain version (with
    normal draws a pre-activation within rounding of 0 flips it)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    def steps(*shape, n, step):
        return torch.randint(-n, n + 1, shape, generator=g,
                             device="cuda").float() * step

    if grid:
        return (steps(B, T, D, n=8, step=1 / 8),
                steps(C, D, F, n=16, step=1 / 128),
                steps(C, F, n=16, step=1 / 128),
                randn(C, F, 3, std=F ** -0.5), randn(C, 3, std=0.1))
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
    before = ghk.LAUNCHES["gmm_head_fwd"]
    got = ghk.gmm_head_fwd(*args)
    torch.cuda.synchronize()
    assert ghk.LAUNCHES["gmm_head_fwd"] == before + 1
    torch.testing.assert_close(got, ghk.gmm_head_fwd_plain(*args),
                               rtol=TOL, atol=TOL)


def test_gmm_head_kernel_empty_input_launches_nothing(cuda):
    args = _inputs(2, 0, 32, 128, 10)
    before = dict(ghk.LAUNCHES)
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


def _assert_grad_close(got, want, name):
    """Within 1e-4 of each element plus 1e-4 of the gradient's largest
    element: a weight gradient sums every row (20,400 at the training
    shape), in per-block partials and then over blocks, where the plain
    version sums in another order, so its rounding grows with its size."""
    err = (got - want).abs()
    bound = TOL * want.abs() + TOL * want.abs().max()
    assert bool((err <= bound).all()), (
        f"{name}: max abs error {err.max().item():.3e}, largest element "
        f"{want.abs().max().item():.3e}")


BWD_SHAPES = [
    (200, 102, 32, 128, 10),    # the training step's target call
    (2, 1, 32, 128, 10),        # fewer rows than one block
    (3, 37, 16, 32, 4),         # D=16, ragged rows
    (5, 300, 64, 256, 3),       # D=64, shared memory above 48 KB
    (1, 513, 64, 64, 1),        # one component
    (4, 129, 16, 96, 7),        # F not a power of two
]


@pytest.mark.parametrize("B,T,D,F,C", BWD_SHAPES)
def test_gmm_head_backward_kernel_matches_plain(cuda, B, T, D, F, C):
    z, w1, b1, w2, _ = _inputs(B, T, D, F, C, grid=True)
    g = torch.randn(B, T, C, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    before = ghk.LAUNCHES["gmm_head_bwd"]
    got = ghk.gmm_head_bwd(z, w1, b1, w2, g)
    torch.cuda.synchronize()
    assert ghk.LAUNCHES["gmm_head_bwd"] == before + 1
    want = ghk.gmm_head_bwd_plain(z, w1, b1, w2, g)
    for name, a, b in zip(("dz", "dw1", "db1", "dw2", "db2"), got, want):
        _assert_grad_close(a, b, name)


def test_gmm_head_backward_kernel_is_deterministic(cuda):
    z, w1, b1, w2, _ = _inputs(200, 102, 32, 128, 10)
    g = torch.randn(200, 102, 10, 3, device="cuda")
    first = ghk.gmm_head_bwd(z, w1, b1, w2, g)
    second = ghk.gmm_head_bwd(z, w1, b1, w2, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_gmm_head_autograd_runs_both_kernels(cuda):
    args = [t.requires_grad_() for t in _inputs(4, 50, 32, 128, 10,
                                                grid=True)]
    before = dict(ghk.LAUNCHES)
    ghk.gmm_head(*args).square().sum().backward()
    torch.cuda.synchronize()
    assert ghk.LAUNCHES["gmm_head_fwd"] == before["gmm_head_fwd"] + 1
    assert ghk.LAUNCHES["gmm_head_bwd"] == before["gmm_head_bwd"] + 1
    ref = [t.detach().clone().requires_grad_() for t in args]
    ghk.gmm_head_fwd_plain(*ref).square().sum().backward()
    for a, b in zip(args, ref):
        _assert_grad_close(a.grad, b.grad, "autograd")


def test_gmm_head_backward_kernel_rejects_what_it_does_not_take(cuda):
    z, w1, b1, w2, _ = _inputs(2, 9, 32, 128, 4)
    g = torch.randn(2, 9, 4, 3, device="cuda")
    with pytest.raises(TypeError):
        ghk.gmm_head_bwd(z, w1, b1, w2, g.double())
    with pytest.raises(ValueError):
        ghk.gmm_head_bwd(z, w1, b1, w2, g.cpu())
    shifted = torch.empty(z.numel() + 1, device="cuda")[1:].view_as(z)
    shifted.copy_(z)
    with pytest.raises(ValueError, match="aligned"):
        ghk.gmm_head_bwd(shifted, w1, b1, w2, g)
