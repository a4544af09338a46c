"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The machine
with the GPU has no JAX, so run them there without the JAX test conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerance rtol = atol = 1e-4: float32 on both sides with TF32 off in
PyTorch.  The GMM kernels' D x F products are 3xTF32 on the tensor cores,
float32 accuracy (tests/test_torch_gmm_tf32.py), summed in another order
(the backward's weight gradients over every row, in per-CTA partials and
then over CTAs); the flash kernels sum a row's softmax online, over key
tiles.

The bfloat16 flash kernels against their plain versions in bfloat16, on
the same bfloat16 inputs: both compute in float32 and round each output
once, so an element may land on the other side of a rounding boundary.
O and dQ: within 2^-7 of each element's magnitude (one bfloat16 ulp at
most) plus 1e-5 (O) or 1e-4 (dQ) of the largest element.  dK and dV: the
plain version sums them into bfloat16 block by block of ``block_q(N)``
rows, as the TPU kernel does, each addition rounding by up to 2^-8 of a
partial sum, where the kernels sum in float32 and round once: within
2^-7 of each element plus (n_blocks + 1) * 2^-8 of the largest.  Against
the plain version summed as the kernels sum them (``per_block=False``),
dK and dV lie within 2^-7 of each element plus 1e-4 of the largest.  lse
is float32: 1e-4.

The EIG fold of location finding (``HiddenLocation.fold_eig_chunk``)
against the plain fold (``eig_fold_plain``) on the card:
the logsumexp (max + log sumexp) of each (row, step) within 1e-5 plus
(Th + 8) float32 ulps of its size.  Each step's term rounds otherwise in
the kernel (products contracted into FMAs, its own logf), and so does
the running sum over the Th steps, up to about an ulp of S each; S, a
sum of negative terms, reaches hundreds of nats, and the largest S set
the logsumexp's size.  The sum of exponentials runs in another order
(per thread, per block, over blocks), which moves it by about 1e-6.

The EIG fold of CES (``CESTask.fold_eig_chunk``) against the plain fold
on the card: each logsumexp within ``ces_fold_tolerance``
(ops/eig_fold_kernel.py), what
float32 rounding of each draw's terms may move it by on both sides,
weighted by the draw's share of the logsumexp: the outer power 1 / rho
multiplies the rounding of the weighted sum by up to 100, so a fixed
number of ulps holds at rho = 1 and not at rho = 0.01.
"""
import math
from pathlib import Path

import pytest
import torch

from aline_tpu_torch import config as tcfg
from aline_tpu_torch.eval import al_curves, eig, live
from aline_tpu_torch.ops import _build
from aline_tpu_torch.ops import eig_fold_kernel as efk
from aline_tpu_torch.ops import flash_attention as fa
from aline_tpu_torch.ops import gmm_head_kernel as ghk
from aline_tpu_torch.ops.roles import build_roles, roles_to_codes
from aline_tpu_torch.parallel.collectives import (
    LogSumExpState,
    lse_init,
    lse_update,
    lse_value,
)
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.base import Task
from aline_tpu_torch.tasks.ces import CESTask
from aline_tpu_torch.tasks.location_finding import HiddenLocation
from aline_tpu_torch.utils import metrics
from aline_tpu_torch.utils.serialization import (
    AL1D_200K_PARAMS,
    BANKED_RUNS,
    load_model,
)

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
    (200, 102, 32, 128, 10),    # the training step's target call
    (2, 1, 32, 128, 10),        # fewer rows than one block
    (1, 1, 32, 128, 10),        # one row
    (2, 37, 32, 128, 10),       # rows not a multiple of the 32-row task
    (3, 37, 16, 32, 4),         # D=16, ragged rows
    (2, 45, 32, 32, 4),         # F=32, C=4
    (5, 300, 64, 256, 3),       # D=64, shared memory above 48 KB
    (3, 37, 64, 128, 10),       # D=64 at the flagship's F and C
    (1, 513, 64, 64, 1),        # one component
    (4, 129, 16, 96, 7),        # F not a power of two
    # on 132 SMs (264 CTAs of 8 warps): the most rows whose components
    # are split over CTAs (1056 32-row tasks, 2 warps' worth each), and
    # just above
    (1, 33792, 32, 128, 10),
    (1, 33793, 32, 128, 10),
    # the most rows whose warps keep their rows resident across components
    # (2112 tasks, one a warp), and just above
    (1, 67583, 32, 128, 10),
    (1, 67585, 32, 128, 10),
    # widths past the narrow kernel: the tiled one (D, F multiples of
    # 128), and widths zero-padded to either (kernel_widths)
    (2, 45, 128, 256, 4),
    (3, 37, 96, 200, 10),       # tiled at D=128, F=256
    (2, 37, 48, 100, 4),        # narrow at D=64, F=104
    (1, 300, 1024, 4096, 2),    # al1d_wide128's head
])
def test_gmm_head_kernel_matches_plain(cuda, B, T, D, F, C):
    args = _inputs(B, T, D, F, C)
    before = _build.LAUNCHES["gmm_head_fwd"]
    got = ghk.gmm_head_fwd(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gmm_head_fwd"] == before + 1
    torch.testing.assert_close(got, ghk.gmm_head_fwd_plain(*args),
                               rtol=TOL, atol=TOL)


def test_gmm_head_kernel_empty_input_launches_nothing(cuda):
    args = _inputs(2, 0, 32, 128, 10)
    before = dict(_build.LAUNCHES)
    assert ghk.gmm_head_fwd(*args).shape == (2, 0, 10, 3)
    assert _build.LAUNCHES == before


def test_gmm_head_kernel_rejects_what_it_does_not_take(cuda):
    z, w1, b1, w2, b2 = _inputs(2, 9, 32, 128, 4)
    with pytest.raises(TypeError):
        ghk.gmm_head_fwd(z.double(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        ghk.gmm_head_fwd(z.cpu(), w1, b1, w2, b2)
    with pytest.raises(ValueError):                          # D=0
        ghk.gmm_head_fwd(*_inputs(2, 9, 0, 128, 4, grid=True))
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
    (100, 102, 32, 128, 10),    # the eval's target shape
    (2, 1, 32, 128, 10),        # fewer rows than one block
    (1, 1, 32, 128, 10),        # one row
    (3, 37, 16, 32, 4),         # D=16, ragged rows
    (2, 37, 32, 32, 4),         # F=32, C=4
    (5, 300, 64, 256, 3),       # D=64, shared memory above 48 KB
    (2, 37, 64, 128, 10),       # D=64 at the flagship's F and C
    (1, 513, 64, 64, 1),        # one component
    (4, 129, 16, 96, 7),        # F not a power of two
    # on 132 SMs a CTA's range is whole 32-row steps: 4224 rows are 132
    # ranges of 32; one row fewer leaves the last range ragged, one more
    # makes the ranges 64 rows
    (1, 4223, 32, 128, 10),
    (33, 128, 32, 128, 10),
    (1, 4225, 32, 128, 10),
    # the tiled form and padded widths, as in the forward's list
    (2, 45, 128, 256, 4),
    (3, 37, 96, 200, 10),
    (2, 37, 48, 100, 4),
    (2, 130, 256, 512, 3),      # two row tiles, the last ragged
]


@pytest.mark.parametrize("B,T,D,F,C", BWD_SHAPES)
def test_gmm_head_backward_kernel_matches_plain(cuda, B, T, D, F, C):
    z, w1, b1, w2, _ = _inputs(B, T, D, F, C, grid=True)
    g = torch.randn(B, T, C, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    before = _build.LAUNCHES["gmm_head_bwd"]
    got = ghk.gmm_head_bwd(z, w1, b1, w2, g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gmm_head_bwd"] == before + 1
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
    before = dict(_build.LAUNCHES)
    ghk.gmm_head(*args).square().sum().backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gmm_head_fwd"] == before["gmm_head_fwd"] + 1
    assert _build.LAUNCHES["gmm_head_bwd"] == before["gmm_head_bwd"] + 1
    ref = [t.detach().clone().requires_grad_() for t in args]
    ghk.gmm_head_fwd_plain(*ref).square().sum().backward()
    for a, b in zip(args, ref):
        _assert_grad_close(a.grad, b.grad, "autograd")


@pytest.mark.parametrize("F", [36, 264])
def test_gmm_head_kernels_refuse_an_f_they_do_not_take(cuda, F):
    """Every F ≥ 1 is taken, as the Pallas kernels take it: 36 and 264
    run zero-padded (to 40 on the narrow kernel; to D=128, F=384 on the
    tiled one) and launch the kernels; F=0 is refused, with no launch and
    no fallback."""
    z, w1, b1, w2, b2 = _inputs(2, 9, 32, F, 4, grid=True)
    g = torch.randn(2, 9, 4, 3, device="cuda")
    before = dict(_build.LAUNCHES)
    torch.testing.assert_close(ghk.gmm_head_fwd(z, w1, b1, w2, b2),
                               ghk.gmm_head_fwd_plain(z, w1, b1, w2, b2),
                               rtol=TOL, atol=TOL)
    for name, a, b in zip(("dz", "dw1", "db1", "dw2", "db2"),
                          ghk.gmm_head_bwd(z, w1, b1, w2, g),
                          ghk.gmm_head_bwd_plain(z, w1, b1, w2, g)):
        assert a.shape == b.shape, name
        _assert_grad_close(a, b, name)
    assert _build.LAUNCHES["gmm_head_fwd"] == before["gmm_head_fwd"] + 1
    assert _build.LAUNCHES["gmm_head_bwd"] == before["gmm_head_bwd"] + 1
    w1, b1, w2 = (torch.empty(*shape, device="cuda")      # F=0
                  for shape in ((4, 32, 0), (4, 0), (4, 0, 3)))
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="F"):
        ghk.gmm_head_fwd(z, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="F"):
        ghk.gmm_head_bwd(z, w1, b1, w2, g)
    assert _build.LAUNCHES == before


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


# -- role-masked flash attention --------------------------------------------

def _flash_inputs(B, H, n_points, n_target, dh, with_time, blind, seed=0):
    """q, k, v, kcode, qrow, dO on the card.  ``blind``: the last batch
    row has no context and no selected target, so its rows see no key
    (or only the time column)."""
    g = torch.Generator().manual_seed(seed)
    ctx = torch.rand(B, n_points, generator=g) < 0.1
    ctx[:, 0] = True
    tmask = torch.rand(n_target, generator=g) < 0.5
    tmask[0] = True
    if blind:
        ctx[-1] = False
        tmask[:] = False
    codes = roles_to_codes(build_roles(ctx, n_target, tmask, with_time))
    N = codes[0].shape[1]
    dense = [torch.randn(B, H, N, dh, generator=g) for _ in range(4)]
    q, k, v, do = (t.cuda() for t in dense)
    return q, k, v, codes[0].cuda(), codes[1].cuda(), do


FLASH_SHAPES = [
    # B, H, n_points, n_target, dh, time token, blind rows
    (8, 4, 2001, 102, 8, False, False),   # the eval slice's N = 2103
    (16, 4, 201, 102, 8, False, False),   # training, N = 303
    (16, 4, 31, 102, 8, False, False),    # burning, N = 133
    (3, 2, 30, 6, 8, True, True),         # N = 37 ragged, blind rows, time
    (2, 3, 40, 9, 16, True, False),       # dh = 16
    (2, 2, 300, 11, 32, False, True),     # dh = 32
    (2, 8, 2000, 47, 64, True, False),    # dh = 64, N = 2048
    (2, 2, 40, 9, 128, True, False),      # dh = 128 (al1d_wide128's)
    (2, 8, 300, 11, 128, False, True),    # dh = 128, blind rows
    (2, 2, 40, 9, 24, True, False),       # dh = 24, run padded to 32
]
# The bf16 backward at dh = 128: each row's D = bf16(sum dO·O) sums 128
# products, in another order in the kernel than in the plain version, and
# one ulp of D moves dQ by up to two: chip_smoke.py phase wide holds it
# with that allowance (``delta_rounding``); here dh <= 64.
BF16_BWD_SHAPES = [s for s in FLASH_SHAPES if s[4] <= 64]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_forward_kernel_matches_plain(cuda, shape):
    q, k, v, kcode, qrow, _ = _flash_inputs(*shape)
    before = _build.LAUNCHES["flash_attn_fwd"]
    o, lse = fa.flash_attn_fwd(q, k, v, kcode, qrow)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_fwd"] == before + 1
    want_o, want_lse = fa.flash_attn_fwd_plain(q, k, v, kcode, qrow)
    torch.testing.assert_close(o, want_o, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, want_lse, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_backward_kernel_matches_plain(cuda, shape):
    q, k, v, kcode, qrow, do = _flash_inputs(*shape, seed=1)
    o, lse = fa.flash_attn_fwd_plain(q, k, v, kcode, qrow)
    before = _build.LAUNCHES["flash_attn_bwd"]
    got = fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_bwd"] == before + 1
    want = fa.flash_attn_bwd_plain(q, k, v, kcode, qrow, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_grad_close(a, b, name)


BF16_ULP = 2.0 ** -7   # bfloat16's spacing, relative to a value, at most


def _assert_bf16_close(got, want, floor, name):
    """Within one bfloat16 ulp of each element plus ``floor`` of the
    largest element."""
    assert got.dtype == want.dtype == torch.bfloat16, name
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = BF16_ULP * want.abs() + floor * want.abs().max()
    assert bool((err <= bound).all()), (
        f"{name}: max abs error {err.max().item():.3e}, largest element "
        f"{want.abs().max().item():.3e}")


def _bf16(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_bf16_flash_forward_kernel_matches_plain(cuda, shape):
    q, k, v, kcode, qrow, _ = _flash_inputs(*shape)
    q, k, v = _bf16(q, k, v)
    before = dict(_build.LAUNCHES)
    o, lse = fa.flash_attn_fwd(q, k, v, kcode, qrow)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_fwd_bf16"] == \
        before["flash_attn_fwd_bf16"] + 1
    assert _build.LAUNCHES["flash_attn_fwd"] == before["flash_attn_fwd"]
    want_o, want_lse = fa.flash_attn_fwd_plain(q, k, v, kcode, qrow)
    _assert_bf16_close(o, want_o, 1e-5, "O")
    torch.testing.assert_close(lse, want_lse, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", BF16_BWD_SHAPES)
def test_bf16_flash_backward_kernel_matches_plain(cuda, shape):
    q, k, v, kcode, qrow, do = _flash_inputs(*shape, seed=1)
    q, k, v, do = _bf16(q, k, v, do)
    o, lse = fa.flash_attn_fwd_plain(q, k, v, kcode, qrow)
    before = _build.LAUNCHES["flash_attn_bwd_bf16"]
    got = fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_bwd_bf16"] == before + 1
    want = fa.flash_attn_bwd_plain(q, k, v, kcode, qrow, o, lse, do)
    N = q.shape[2]
    blocks = -(-N // fa.block_q(N))
    for name, a, b, floor in zip(("dq", "dk", "dv"), got, want,
                                 (TOL, *(2 * [(blocks + 1) * 2.0 ** -8]))):
        _assert_bf16_close(a, b, floor, name)
    once = fa.flash_attn_bwd_plain(q, k, v, kcode, qrow, o, lse, do,
                                   per_block=False)
    for name, a, b in zip(("dk", "dv"), got[1:], once[1:]):
        _assert_bf16_close(a, b, TOL, f"{name} vs summed once")


def test_bf16_flash_autograd_runs_both_kernels(cuda):
    q, k, v, kcode, qrow, do = _flash_inputs(4, 4, 201, 102, 8, True, True)
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    before = dict(_build.LAUNCHES)
    out = fa.flash_role_attention(*leaves, kcode, qrow)
    out.backward(do.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)
    for name in ("flash_attn_fwd_bf16", "flash_attn_bwd_bf16"):
        assert _build.LAUNCHES[name] == before[name] + 1, name
    again = [t.detach().clone().requires_grad_() for t in leaves]
    fa.flash_role_attention(*again, kcode, qrow).backward(
        do.to(torch.bfloat16))
    for a, b in zip(leaves, again):          # no atomics: bitwise
        assert torch.equal(a.grad, b.grad)


def test_flash_backward_kernel_is_deterministic(cuda):
    q, k, v, kcode, qrow, do = _flash_inputs(16, 4, 201, 102, 8, True, True)
    o, lse = fa.flash_attn_fwd(q, k, v, kcode, qrow)
    first = fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do)
    second = fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_autograd_runs_both_kernels(cuda):
    """Where every row sees a key, the kernels' gradient is autograd's
    through the plain forward."""
    q, k, v, kcode, qrow, do = _flash_inputs(4, 4, 201, 102, 8, True, False)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(_build.LAUNCHES)
    fa.flash_role_attention(*leaves, kcode, qrow).backward(do)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_fwd"] == before["flash_attn_fwd"] + 1
    assert _build.LAUNCHES["flash_attn_bwd"] == before["flash_attn_bwd"] + 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attn_fwd_plain(*ref, kcode, qrow)[0].backward(do)
    for a, b in zip(leaves, ref):
        _assert_grad_close(a.grad, b.grad, "autograd")


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, kcode, qrow, do = _flash_inputs(2, 2, 20, 5, 8, False, False)
    with pytest.raises(TypeError):
        fa.flash_attn_fwd(q.bfloat16(), k, v, kcode, qrow)
    with pytest.raises(ValueError, match="dh"):
        fa.flash_attn_fwd(*_flash_inputs(2, 2, 20, 5, 136, False, False)[:5])
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attn_fwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                          k, v, kcode, qrow)
    with pytest.raises(ValueError):
        fa.flash_attn_fwd(q, k, v, kcode.cpu(), qrow)
    o, lse = fa.flash_attn_fwd(q, k, v, kcode, qrow)
    with pytest.raises(TypeError):
        fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do.double())


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_plan_kernel_matches_plain_bitwise(cuda, shape):
    _, _, _, kcode, qrow, _ = _flash_inputs(*shape)
    before = _build.LAUNCHES["flash_plan"]
    plan = fa.flash_plan(kcode, qrow)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_plan"] == before + 1
    for name, a, b in zip(fa.FlashPlan._fields, plan,
                          fa.flash_plan_plain(kcode, qrow)):
        assert torch.equal(a, b), name


def test_flash_kernels_take_a_given_plan(cuda):
    """A plan passed in is the one the kernels walk: no second plan, and
    the same results as with the plan they build themselves."""
    q, k, v, kcode, qrow, do = _flash_inputs(16, 4, 201, 102, 8, True, True)
    plan = fa.flash_plan(kcode, qrow)
    before = _build.LAUNCHES["flash_plan"]
    o, lse = fa.flash_attn_fwd(q, k, v, kcode, qrow, plan)
    got = fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do, plan)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_plan"] == before
    o2, lse2 = fa.flash_attn_fwd(q, k, v, kcode, qrow)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b in zip(got, fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="plan"):
        fa.flash_attn_fwd(q, k, v, kcode, qrow, plan._replace(
            key_perm=plan.key_perm[:-1]))


# -- the EIG fold of location finding -----------------------------------------

# the BED cell's chunk (B=200, Th=35: chunk_size caps Lc at 9,586 draws; the
# last of L=1e6's 105 chunks holds 3,056)
CELL_LC, CELL_LAST = 9586, 3056
# (B, Th, Lc, K, prior, n_valid, filled state)
FOLD_CASES = {
    "cell": (200, 35, CELL_LC, 1, "uniform", CELL_LC, False),
    "cell, filled": (200, 35, CELL_LC, 1, "uniform", CELL_LC, True),
    "cell, last chunk": (200, 35, CELL_LC, 1, "uniform", CELL_LAST, True),
    "cell, n_valid 0": (200, 35, CELL_LC, 1, "uniform", 0, True),
    "cell, n_valid 0, empty": (200, 35, CELL_LC, 1, "uniform", 0, False),
    "cell, n_valid 1": (200, 35, CELL_LC, 1, "uniform", 1, False),
    "cell, normal prior": (200, 35, CELL_LC, 1, "normal", CELL_LC, True),
    "K=2 (thetas through L1)": (64, 35, 3000, 2, "uniform", 3000, True),
    "K=3": (32, 12, 2000, 3, "uniform", 1500, True),
    "Th=1": (200, 1, CELL_LC, 1, "uniform", CELL_LC, False),
    "Th=65": (100, 65, 4000, 1, "uniform", 4000, True),
    "Th=200": (50, 200, 3000, 1, "normal", 2000, True),
}


def _loc_task(K=1, prior="uniform"):
    return HiddenLocation(tcfg.parse_overrides(
        ["task=location_finding", f"task.K={K}",
         f"task.n_target_theta={2 * K}", f"task.theta_dist={prior}"]).task)


def _fold_inputs(B, Th, Lc, K=1, prior="uniform", filled=False, seed=0):
    """A task, a state, designs x [B, Th, 2] and outcomes y [B, Th] of
    rows simulated under their own sources, and Lc draws of the prior."""
    task = _loc_task(K, prior)
    g = torch.Generator(device="cuda").manual_seed(seed)
    theta_0 = task.sample_theta(g, (B,))
    x = task.unnormalise_design(task.sample_data(g, B, Th))
    y = task.simulate(g, x, theta_0[:, None])[..., 0].contiguous()
    state = lse_init((B, Th), device="cuda")
    if filled:
        state = lse_update(state, -60.0 * torch.rand(
            5, B, Th, generator=g, device="cuda"), axis=0)
    return task, state, x, y, task.sample_theta(g, (Lc, B))


def _assert_lse_close(got, want, Th):
    a, b = lse_value(got), lse_value(want)
    inf = torch.isinf(b)
    assert torch.equal(a[inf], b[inf])
    tol = 1e-5 + (Th + 8) * 2.0 ** -24 * b[~inf].abs()
    err = (a[~inf] - b[~inf]).abs()
    assert (err <= tol).all(), f"max err {err.max():.3e}"


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_loc_eig_fold_kernel_matches_plain(cuda, case):
    B, Th, Lc, K, prior, n, filled = FOLD_CASES[case]
    task, state, x, y, thetas = _fold_inputs(B, Th, Lc, K, prior, filled)
    before = _build.LAUNCHES["loc_eig_fold"]
    got = task.fold_eig_chunk(state, x, y, thetas, n)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["loc_eig_fold"] == before + 1
    want = efk.eig_fold_plain(state, x, y, thetas, n, task.log_likelihood)
    _assert_lse_close(got, want, Th)
    if n == 0:
        # no valid draw: the state bit for bit
        assert torch.equal(got.max, state.max)
        assert torch.equal(got.sumexp, state.sumexp)


def test_loc_eig_fold_kernel_is_deterministic(cuda):
    task, state, x, y, thetas = _fold_inputs(200, 35, CELL_LC, filled=True)
    first = task.fold_eig_chunk(state, x, y, thetas, CELL_LAST)
    second = task.fold_eig_chunk(state, x, y, thetas, CELL_LAST)
    assert torch.equal(first.max, second.max)       # no atomics: bitwise
    assert torch.equal(first.sumexp, second.sumexp)


def test_loc_bounds_launch_one_kernel_a_chunk(cuda):
    """The BED cell's batch (B=200, Th=35, L=1e6): 105 chunks, one launch
    each."""
    task, _, x, y, _ = _fold_inputs(200, 35, 1, seed=1)
    theta_0 = task.sample_theta(torch.Generator(device="cuda").manual_seed(2),
                                (200,))
    L = 1_000_000
    Lc = eig.chunk_size(L, 200, 35, 32_768)
    assert (Lc, L - (math.ceil(L / Lc) - 1) * Lc) == (CELL_LC, CELL_LAST)
    before = _build.LAUNCHES["loc_eig_fold"]
    pce, nmc = eig.compute_eig_from_history(task, theta_0, x, y[..., None],
                                            L, 7, stepwise=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["loc_eig_fold"] - before == 105 == math.ceil(L / Lc)
    assert torch.isfinite(pce).all() and torch.isfinite(nmc).all()
    assert (nmc - pce >= math.log(L / (L + 1)) - 1e-5).all()


def test_loc_L_checkpoints_equal_separate_calls_on_the_card(cuda):
    task, _, x, y, _ = _fold_inputs(40, 12, 1, seed=3)
    theta_0 = task.sample_theta(torch.Generator(device="cuda").manual_seed(4),
                                (40,))
    args = (task, theta_0, x, y[..., None])
    curve = eig.compute_eig_from_history(*args, 20_000, 5, L_chunk=3000,
                                         stepwise=True,
                                         L_checkpoints=[5000, 12_000])
    assert sorted(curve) == [6000, 12_000, 20_000]
    for L_eff, (pce_c, nmc_c) in curve.items():
        pce, nmc = eig.compute_eig_from_history(*args, L_eff, 5,
                                                L_chunk=3000, stepwise=True)
        assert torch.equal(pce_c, pce) and torch.equal(nmc_c, nmc), L_eff


def test_loc_bounds_never_wait_for_the_host(cuda):
    task, _, x, y, _ = _fold_inputs(200, 35, 1, seed=5)
    theta_0 = task.sample_theta(torch.Generator(device="cuda").manual_seed(6),
                                (200,))
    eig.compute_eig_from_history(task, theta_0, x, y[..., None], 20_000, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pce, nmc = eig.compute_eig_from_history(
            task, theta_0, x, y[..., None], 100_000, 5, stepwise=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(pce).all() and torch.isfinite(nmc).all()


def test_loc_eig_fold_kernel_rejects_what_it_does_not_take(cuda):
    task, state, x, y, thetas = _fold_inputs(8, 5, 100)

    def fold(state=state, x=x, y=y, thetas=thetas):
        return task.fold_eig_chunk(state, x, y, thetas, 100)

    with pytest.raises(TypeError):
        fold(thetas=thetas.double())
    with pytest.raises(TypeError):
        fold(x=x.bfloat16())
    with pytest.raises(ValueError, match="is on"):
        fold(state=LogSumExpState(state.max.cpu(), state.sumexp.cpu()))
    with pytest.raises(ValueError, match="shape"):
        fold(y=y[:, :4].contiguous())
    with pytest.raises(ValueError, match="shape"):
        fold(thetas=thetas[:, :7].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fold(thetas=thetas.transpose(0, 1).contiguous().transpose(0, 1))


# the kernel's bits on fixed inputs (``_loc_fixed_inputs``) as
# loc_eig_fold.cu gave them on an H100 (CUDA 12.8) while it held its own
# streaming logsumexp, before that moved to eig_fold_reduce.cuh, shared with
# the CES fold: SHA-256 of the new max then sumexp, float32 bytes
LOC_FIXED_DIGEST = ("3c07ca40ec2a207fedf3fd6afdadafa2"
                    "e7e2fcdd1f2ed244e8a7831a4dfa6989")


def _loc_fixed_inputs():
    """A state, x, y and draws of the BED cell's chunk shape drawn with
    numpy (the same on every machine), on the card."""
    import numpy as np
    rng = np.random.default_rng(2024)
    B, Th, Lc = 200, 35, CELL_LC
    f32 = np.float32
    x = rng.uniform(-4, 4, size=(B, Th, 2)).astype(f32)
    y = rng.normal(1.0, 1.0, size=(B, Th)).astype(f32)
    thetas = rng.uniform(-4, 4, size=(Lc, B, 1, 2)).astype(f32)
    state = lse_update(lse_init((B, Th)), torch.from_numpy(
        -60.0 * rng.uniform(size=(5, B, Th)).astype(f32)), axis=0)
    cuda = [torch.from_numpy(a).cuda() for a in (x, y, thetas)]
    return (LogSumExpState(state.max.cuda(), state.sumexp.cuda()),
            *cuda)


def loc_fixed_digest():
    """SHA-256 of ``loc_eig_fold``'s result on ``_loc_fixed_inputs``."""
    state, x, y, thetas = _loc_fixed_inputs()
    return _digest(_loc_task().fold_eig_chunk(state, x, y, thetas,
                                              CELL_LAST))


def _digest(state):
    """SHA-256 of a fold's new max then sumexp, float32 bytes."""
    import hashlib
    return hashlib.sha256(state.max.cpu().numpy().tobytes()
                          + state.sumexp.cpu().numpy().tobytes()).hexdigest()


def test_loc_eig_fold_bits_unchanged_by_the_shared_reduction(cuda):
    assert loc_fixed_digest() == LOC_FIXED_DIGEST


# -- the EIG fold of CES --------------------------------------------------------

# the CES cell's chunk (B=100, Th=16: Lc at the L_chunk cap of 32,768; the
# last of L=1e7's 306 chunks holds 5,760)
CES_LC, CES_LAST, CES_CHUNKS = 32_768, 5_760, 306
# (B, Th, Lc, y, rho, log u, n_valid, filled state); y and the draws as
# tests/test_torch_eig_fold.py's _ces_case makes them
CES_CASES = {
    "cell": (100, 16, CES_LC, "sim", None, None, CES_LC, False),
    "cell, filled": (100, 16, CES_LC, "sim", None, None, CES_LC, True),
    "cell, last chunk": (100, 16, CES_LC, "sim", None, None, CES_LAST, True),
    "cell, n_valid 0": (100, 16, CES_LC, "sim", None, None, 0, True),
    "cell, n_valid 1": (100, 16, CES_LC, "sim", None, None, 1, False),
    "inside": (50, 16, 8192, "inside", None, None, 8192, False),
    "at the limits": (50, 16, 8192, "limits", None, None, 8192, True),
    "outside": (50, 16, 8192, "outside", None, None, 8192, False),
    "rho 0.01": (50, 16, 8192, "sim", 0.01, None, 8192, False),
    "rho 0.01, inside": (50, 16, 8192, "inside", 0.01, None, 8192, False),
    "rho 1": (50, 16, 8192, "sim", 1.0, None, 8192, True),
    "log u in the tails": (50, 16, 8192, "sim", None, "tails", 8192, False),
    "log u in the tails, inside": (50, 16, 8192, "inside", None, "tails",
                                   8192, False),
    "Th 1": (100, 1, CES_LC, "sim", None, None, CES_LC, False),
    "Th 40": (40, 40, 8192, "inside", None, None, 6000, True),
}


def _ces_task(tail_mode="log_ndtr"):
    return CESTask(tcfg.parse_overrides(
        ["task=ces", f"task.tail_mode={tail_mode}"]).task)


def _ces_fold_inputs(B, Th, Lc, ys="sim", rho=None, log_u=None,
                     filled=False, seed=0):
    """The task, a state, designs x [B, Th, 6], outcomes y [B, Th] and
    Lc draws [Lc, B, 5], on the card (see ``CES_CASES``)."""
    task = _ces_task()
    g = torch.Generator(device="cuda").manual_seed(seed)
    theta_0 = task.sample_theta(g, (B,))
    x = task.sample_data(g, B, Th)
    y = task.simulate(g, x, theta_0[:, None])[..., 0]
    lo, hi = (torch.tensor(v, dtype=torch.float32).item()
              for v in (task.epsilon, 1.0 - task.epsilon))
    if ys == "inside":
        y = 0.01 + 0.98 * torch.rand(B, Th, generator=g, device="cuda")
    elif ys == "limits":
        y = torch.where(torch.arange(B * Th, device="cuda").view(B, Th) % 2
                        == 0, hi, lo)
    elif ys == "outside":
        y = y.clone()
        y[:, Th // 2] = torch.where(torch.arange(B, device="cuda") % 2 == 0,
                                    torch.nextafter(torch.tensor(hi),
                                                    torch.tensor(1.0)).item(),
                                    torch.nextafter(torch.tensor(lo),
                                                    torch.tensor(0.0)).item())
    thetas = task.sample_theta(g, (Lc, B))
    if rho is not None:
        thetas[..., 0] = rho
    if log_u == "tails":
        thetas[..., 4] = 1.0 + 3.0 * 5.5 * torch.where(
            torch.rand(Lc, B, generator=g, device="cuda") < 0.5, -1.0, 1.0)
    state = lse_init((B, Th), device="cuda")
    if filled:
        state = lse_update(state, -60.0 * torch.rand(
            5, B, Th, generator=g, device="cuda"), axis=0)
    return task, state, x, y.contiguous(), thetas


def _assert_ces_close(got, want, tol):
    a, b = lse_value(got).double(), lse_value(want).double()
    inf = torch.isinf(b)
    assert torch.equal(a[inf], b[inf])
    err = (a[~inf] - b[~inf]).abs()
    assert (err <= tol[~inf]).all(), (
        f"max err {err.max():.3e}, worst share of the tolerance "
        f"{(err / tol[~inf]).max():.3f}")


@pytest.mark.parametrize("case", list(CES_CASES))
def test_ces_eig_fold_kernel_matches_plain(cuda, case):
    B, Th, Lc, ys, rho, log_u, n, filled = CES_CASES[case]
    task, state, x, y, thetas = _ces_fold_inputs(B, Th, Lc, ys, rho, log_u,
                                                 filled)
    before = _build.LAUNCHES["ces_eig_fold"]
    got = task.fold_eig_chunk(state, x, y, thetas, n)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ces_eig_fold"] == before + 1
    want = efk.eig_fold_plain(state, x, y, thetas, n, task.log_likelihood)
    _assert_ces_close(got, want, efk.ces_fold_tolerance(
        state, task, x, y, thetas, n))
    if n == 0:
        assert torch.equal(got.max, state.max)
        assert torch.equal(got.sumexp, state.sumexp)


def test_ces_eig_fold_kernel_is_deterministic(cuda):
    task, state, x, y, thetas = _ces_fold_inputs(100, 16, CES_LC,
                                                 filled=True)
    first = task.fold_eig_chunk(state, x, y, thetas, CES_LAST)
    second = task.fold_eig_chunk(state, x, y, thetas, CES_LAST)
    assert torch.equal(first.max, second.max)       # no atomics: bitwise
    assert torch.equal(first.sumexp, second.sumexp)


def _ces_history(B, Th, seed):
    task, _, x, y, _ = _ces_fold_inputs(B, Th, 1, seed=seed)
    theta_0 = task.sample_theta(torch.Generator(device="cuda").manual_seed(
        seed + 1), (B,))
    return task, theta_0, x, y[..., None]


# the kernel's bits on fixed inputs (``_ces_fixed_inputs``) as
# ces_eig_fold.cu gave them on an H100 (CUDA 12.8), launched through its
# own wrapper and through ``CESTask.fold_eig_chunk`` alike: SHA-256 of the
# new max then sumexp, float32 bytes
CES_FIXED_DIGEST = ("da9efd6b7db6a6e84bb6044c9ac579d6"
                    "dd1aa566e69ccae920610d3e36ea79e7")


def _ces_fixed_inputs():
    """A state, x, y and draws of the CES cell's chunk shape drawn with
    numpy (the same on every machine), on the card: a quarter of the
    outcomes at each censoring limit, the rest inside."""
    import numpy as np
    rng = np.random.default_rng(2025)
    B, Th, Lc = 100, 16, CES_LC
    f32 = np.float32
    task = _ces_task()
    lo, hi = f32(task.epsilon), f32(1.0 - task.epsilon)
    x = rng.uniform(0, 100, size=(B, Th, 6)).astype(f32)
    y = rng.uniform(0.01, 0.99, size=(B, Th)).astype(f32)
    at = rng.uniform(size=(B, Th))
    y = np.where(at < 0.25, lo, np.where(at > 0.75, hi, y)).astype(f32)
    thetas = np.concatenate(
        [rng.uniform(0.01, 1.0, size=(Lc * B, 1)),
         rng.dirichlet(np.ones(3), size=Lc * B),
         rng.normal(1.0, 3.0, size=(Lc * B, 1))],
        axis=-1).astype(f32).reshape(Lc, B, 5)
    state = lse_update(lse_init((B, Th)), torch.from_numpy(
        -60.0 * rng.uniform(size=(5, B, Th)).astype(f32)), axis=0)
    cuda = [torch.from_numpy(a).cuda() for a in (x, y, thetas)]
    return (LogSumExpState(state.max.cuda(), state.sumexp.cuda()),
            *cuda)


def ces_fixed_digest():
    """SHA-256 of ``ces_eig_fold``'s result on ``_ces_fixed_inputs``."""
    state, x, y, thetas = _ces_fixed_inputs()
    return _digest(_ces_task().fold_eig_chunk(state, x, y, thetas,
                                              CES_LAST))


def test_ces_eig_fold_bits_unchanged(cuda):
    assert ces_fixed_digest() == CES_FIXED_DIGEST


def test_ces_bounds_launch_one_kernel_a_chunk(cuda, monkeypatch):
    """The CES cell's batch (B=100, Th=16, L=1e7): 306 chunks, one launch
    each, and nothing of the generic fold."""
    task, theta_0, x, y = _ces_history(100, 16, 1)
    L = 10_000_000
    Lc = eig.chunk_size(L, 100, 16, 32_768)
    assert (Lc, L - (math.ceil(L / Lc) - 1) * Lc) == (CES_LC, CES_LAST)
    before = _build.LAUNCHES["ces_eig_fold"]
    generic = []
    monkeypatch.setattr(Task, "fold_eig_chunk",
                        lambda *a: generic.append("generic"))
    monkeypatch.setattr(efk, "eig_fold_plain",
                        lambda *a: generic.append("plain"))
    pce, nmc = eig.compute_eig_from_history(task, theta_0, x, y, L, 7,
                                            stepwise=True)
    torch.cuda.synchronize()
    assert generic == []
    assert _build.LAUNCHES["ces_eig_fold"] - before == CES_CHUNKS
    assert torch.isfinite(pce).all() and torch.isfinite(nmc).all()
    assert (nmc - pce >= math.log(L / (L + 1)) - 1e-5).all()


def test_ces_bounds_match_the_plain_fold_on_the_card(cuda, monkeypatch):
    """The bounds of a batch at the CES cell's shape (B=100, Th=16,
    L=1e6: 31 chunks) through the kernel and through the plain fold on
    the card: within 2e-4 plus 32 float32 ulps of the bound's size.  The
    kernel rounds the utilities and the z-score as the plain fold does;
    what is left, its log_ndtr and its running sum's order, moves the
    terms by ulps of their size, which a row whose contrastive draws all
    explain its outcomes badly carries into a bound of thousands.  An ulp
    of a utility, over sigma (down to 1e-4 of it), moved the bounds by up
    to 4e-3 on the benchmark's traces where the kernel rounded the
    utilities otherwise (bounds of 18 and 37)."""
    task, theta_0, x, y = _ces_history(100, 16, 9)
    args = (task, theta_0, x, y, 1_000_000, 11)
    got = eig.compute_eig_from_history(*args, stepwise=True)

    def plain(kernel, state, x_, y_, th, n, *, loglik, **kw):
        return efk.eig_fold_plain(state, x_, y_, th, n, loglik)

    monkeypatch.setattr(efk, "eig_fold", plain)
    want = eig.compute_eig_from_history(*args, stepwise=True)
    for g, w in zip(got, want):
        err = (g - w).abs()
        tol = 2e-4 + 32 * 2.0 ** -24 * w.abs()
        worst = int((err / tol).argmax())
        assert (err <= tol).all(), (
            f"max err {err.max():.3e}; worst against the tolerance "
            f"{err.flatten()[worst]:.3e} at a bound of "
            f"{w.flatten()[worst]:.3f}")


def test_ces_L_checkpoints_equal_separate_calls_on_the_card(cuda):
    task, theta_0, x, y = _ces_history(40, 16, 3)
    args = (task, theta_0, x, y)
    curve = eig.compute_eig_from_history(*args, 20_000, 5, L_chunk=3000,
                                         stepwise=True,
                                         L_checkpoints=[5000, 12_000])
    assert sorted(curve) == [6000, 12_000, 20_000]
    for L_eff, (pce_c, nmc_c) in curve.items():
        pce, nmc = eig.compute_eig_from_history(*args, L_eff, 5,
                                                L_chunk=3000, stepwise=True)
        assert torch.equal(pce_c, pce) and torch.equal(nmc_c, nmc), L_eff


def test_ces_bounds_never_wait_for_the_host(cuda):
    task, theta_0, x, y = _ces_history(100, 16, 5)
    eig.compute_eig_from_history(task, theta_0, x, y, 40_000, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pce, nmc = eig.compute_eig_from_history(task, theta_0, x, y,
                                                200_000, 5, stepwise=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(pce).all() and torch.isfinite(nmc).all()


def test_ces_eig_fold_kernel_rejects_what_it_does_not_take(cuda):
    task, state, x, y, thetas = _ces_fold_inputs(8, 5, 100)

    def fold(state=state, x=x, y=y, thetas=thetas):
        return task.fold_eig_chunk(state, x, y, thetas, 100)

    with pytest.raises(TypeError):
        fold(thetas=thetas.double())
    with pytest.raises(TypeError):
        fold(x=x.bfloat16())
    with pytest.raises(ValueError, match="is on"):
        fold(state=LogSumExpState(state.max.cpu(), state.sumexp.cpu()))
    with pytest.raises(ValueError, match="shape"):
        fold(y=y[:, :4].contiguous())
    with pytest.raises(ValueError, match="shape"):
        fold(thetas=thetas[..., :4].contiguous())
    with pytest.raises(ValueError, match="shape"):
        fold(x=x[..., :5].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fold(thetas=thetas.transpose(0, 1).contiguous().transpose(0, 1))


# -- the AL rollout as one CUDA graph (eval/al_curves.py) --------------------

# the live experiment's shape, and a pool of 1,101 tokens whose posterior
# runs the GMM kernel (bfloat16 takes it from FUSED_MIN_TOKENS = 1024)
ROLLOUT_SHAPES = {"live": (1, 200, 30), "pool": (4, 1100, 10)}


def _flagship():
    run_dir = Path(__file__).resolve().parents[1] / "checkpoints" \
        / "al1d_200k"
    return load_model(run_dir, AL1D_200K_PARAMS, "cuda")


def _gp_batch(cfg, B, n_query, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return build_task(cfg.task).sample_batch(g, B, n_query=n_query)


def _eager(model, batch, T, strategy):
    """The rollout's steps run eagerly on the card (the graph's
    reference): ``al_rollout_curves`` without its graph."""
    with torch.no_grad():
        return al_curves._rollout(model, batch, None, None, T, strategy,
                                  False, *al_curves.fixed_by_batch(batch))


def _counted(model, batch, T, strategy, generator=None):
    """``al_rollout_curves``' result, with the graphs it captured and
    replayed (the ``al.rollout`` span's counters)."""
    metrics.set_tracing(True)
    try:
        out = al_curves.al_rollout_curves(model, batch, T, generator,
                                          strategy=strategy)
        spans = [s for s in metrics.collect() if s.name == "al.rollout"]
    finally:
        metrics.set_tracing(False)
        metrics.collect()
    return (out, sum(s.counts.get("al.graph_captures", 0) for s in spans),
            sum(s.counts.get("al.graph_replays", 0) for s in spans))


def _same_bits(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("shape", list(ROLLOUT_SHAPES))
@pytest.mark.parametrize("strategy", ["aline", "uncertainty"])
def test_graphed_rollout_equals_eager_bitwise(cuda, shape, strategy):
    B, n_query, T = ROLLOUT_SHAPES[shape]
    cfg, model = _flagship()
    first, second = (_gp_batch(cfg, B, n_query, seed) for seed in (1, 2))
    gmm_before = _build.LAUNCHES["gmm_head_fwd"]
    got1, captures, replays = _counted(model, first, T, strategy)
    assert (captures, replays) == (1, 0)
    got2, captures, replays = _counted(model, second, T, strategy)
    assert (captures, replays) == (0, 1)
    # the pool's posterior through the GMM kernel at every forward, in the
    # capturing call's eager pass and in the replay alike
    per_rollout = (T + 1) * (shape == "pool")
    assert _build.LAUNCHES["gmm_head_fwd"] - gmm_before == 2 * per_rollout
    want1 = _eager(model, first, T, strategy)
    want2 = _eager(model, second, T, strategy)
    _same_bits(got1, want1)
    _same_bits(got2, want2)
    assert not torch.equal(got1["log_prob"], got2["log_prob"])


def test_graphed_rollout_captures_per_key(cuda):
    cfg, model = _flagship()
    live = _gp_batch(cfg, 1, 200, 1)
    calls = [(live, 30, "aline"), (live, 30, "uncertainty"),
             (live, 29, "aline"), (_gp_batch(cfg, 2, 200, 1), 30, "aline"),
             (_gp_batch(cfg, 1, 201, 1), 30, "aline"),
             (live.replace(target_mask=torch.arange(102, device="cuda")
                           < 100), 30, "aline")]
    for batch, T, strategy in calls:
        _, captures, replays = _counted(model, batch, T, strategy)
        assert (captures, replays) == (1, 0), (T, strategy)
    for batch, T, strategy in calls:
        got, captures, replays = _counted(model, batch, T, strategy)
        assert (captures, replays) == (0, 1), (T, strategy)
        _same_bits(got, _eager(model, batch, T, strategy))


def test_random_rollout_never_captures(cuda):
    cfg, model = _flagship()
    batch = _gp_batch(cfg, 2, 200, 1)
    outs = []
    for _ in range(2):
        g = torch.Generator(device="cuda").manual_seed(5)
        out, captures, replays = _counted(model, batch, 30, "random", g)
        assert (captures, replays) == (0, 0)
        outs.append(out)
    _same_bits(outs[0], outs[1])
    assert not al_curves._graphs.get(model)


def test_graphed_rollout_outputs_do_not_alias(cuda):
    cfg, model = _flagship()
    batches = [_gp_batch(cfg, 1, 200, seed) for seed in (1, 2, 3)]
    outs = [al_curves.al_rollout_curves(model, b, 30) for b in batches]
    kept = [{k: v.clone() for k, v in o.items()} for o in outs]
    al_curves.al_rollout_curves(model, batches[0], 30)
    ptrs = [v.data_ptr() for o in outs for v in o.values()]
    assert len(set(ptrs)) == len(ptrs)
    for o, k in zip(outs, kept):
        _same_bits(o, k)
    assert not torch.equal(kept[1]["log_prob"], kept[2]["log_prob"])


def test_rollout_graphs_kept_for_one_model_at_a_time(cuda):
    cfg, first = _flagship()
    _, second = _flagship()
    batch = _gp_batch(cfg, 1, 200, 1)
    al_curves.al_rollout_curves(first, batch, 30)
    assert list(al_curves._graphs) == [first]
    got, captures, replays = _counted(second, batch, 30, "aline")
    assert (captures, replays) == (1, 0)
    assert list(al_curves._graphs) == [second]
    _same_bits(got, _eager(second, batch, 30, "aline"))
    _, captures, replays = _counted(first, batch, 30, "aline")
    assert (captures, replays) == (1, 0)


# -- the live session as one CUDA graph a trial (eval/live.py) --------------

PSYCH_MASKS = ([True, True, False, False], [False, False, True, True],
               [True, True, True, True])


def _psych():
    run_dir = Path(__file__).resolve().parents[1] / "checkpoints" \
        / "psych_100k"
    return load_model(run_dir, BANKED_RUNS["psych_100k"][1], "cuda")


def _session(model, batch, T, eager=False):
    """A session at the eval protocol's shape fed the batch's outcomes;
    ``eager``: its steps run without a graph (``live._trial`` on its own
    state).  Returns (designs [B, T], the posterior, the counters of its
    spans and of the span open around it, where the posterior's replay
    counts)."""
    metrics.set_tracing(True)
    try:
        with metrics.span("experiment"):
            s = live.LiveExperiment(model, batch, T)
            if eager:
                s._cuda = False
                s._st = {n: t.clone() for n, t in s._st.items()}
            y = batch.y.cpu()
            rows = torch.arange(batch.batch_size)
            idxs = []
            for _ in range(T):
                idx, _ = s.propose()
                idx = idx.cpu()
                s.observe(y[rows, idx])
                idxs.append(idx)
            post = s.posterior()
        spans = metrics.collect()
    finally:
        metrics.set_tracing(False)
        metrics.collect()
    counted = {n: sum(sp.counts.get(n, 0) for sp in spans)
               for n in ("live.trials", "live.graph_captures",
                         "live.graph_replays")}
    return torch.stack(idxs, 1), post, counted


def _same_posterior(a, b):
    for got, want in zip((a.gmm.mixture_means, a.gmm.mixture_stds,
                          a.gmm.mixture_weights, a.idx, a.x, a.y),
                         (b.gmm.mixture_means, b.gmm.mixture_stds,
                          b.gmm.mixture_weights, b.idx, b.x, b.y)):
        assert torch.equal(got, want)


def test_graphed_session_equals_eager_and_the_rollout_bitwise(cuda):
    cfg, model = _psych()
    task = build_task(cfg.task)
    for seed, mask in zip((1, 2, 3), PSYCH_MASKS):
        batch = task.sample_batch(torch.Generator(device="cuda").manual_seed(
            seed), 1, n_query=300).replace(
                target_mask=torch.tensor(mask, device="cuda"))
        got_idx, got, _ = _session(model, batch, 30)
        want_idx, want, _ = _session(model, batch, 30, eager=True)
        assert torch.equal(got_idx, want_idx)
        _same_posterior(got, want)
        roll = al_curves.al_rollout_curves(model, batch, 30)
        assert torch.equal(got_idx, roll["idx"].cpu())
        lp, rmse = al_curves.posterior_curves(
            got.gmm, batch.target_all[..., 0], got.target_weights)
        assert torch.equal(lp, roll["log_prob"][:, -1])
        assert torch.equal(rmse, roll["rmse"][:, -1])


def test_three_masks_capture_three_graphs_then_replay(cuda):
    cfg, model = _psych()
    task = build_task(cfg.task)
    batch = task.sample_batch(torch.Generator(device="cuda").manual_seed(5),
                              1, n_query=300)
    T = 30
    for rnd in range(2):
        for mask in PSYCH_MASKS:
            b = batch.replace(target_mask=torch.tensor(mask, device="cuda"))
            _, _, counted = _session(model, b, T)
            captures = 1 if rnd == 0 else 0
            assert counted == {"live.trials": T,
                               "live.graph_captures": captures,
                               "live.graph_replays": T + 1 - captures}
    graphs = al_curves._graphs.of(model).graphs
    assert sum(k[0] == "live" for k in graphs) == 3


def test_a_session_whose_graph_was_taken_is_refused(cuda):
    cfg, model = _psych()
    batch = build_task(cfg.task).sample_batch(
        torch.Generator(device="cuda").manual_seed(6), 1, n_query=300)
    first = live.LiveExperiment(model, batch, 4)
    first.propose()
    live.LiveExperiment(model, batch, 4)
    with pytest.raises(RuntimeError, match="taken"):
        first.observe(1.0)


# -- the training rollout as CUDA graphs (train/graph.py) --------------------

def _train_cfg(tmp_path, attention, attend_to, B=50, T=10, n_query=60):
    """The flagship's run config (bf16) cut to B rows, T steps and an
    n_query pool, main phase from epoch 0, under ``attention``; the split
    mask by ``attend_to`` (None: the fair coin)."""
    d = tcfg.to_dict(tcfg.load_config(str(
        Path(__file__).resolve().parents[1] / "checkpoints" / "al1d_200k")))
    d.update(batch_size=B, T=T, min_T=T, burning_epoch=0, max_epoch=1000,
             checkpoint=0, load_checkpoint=False, verbose=1000,
             output_dir=str(tmp_path))
    d["task"] = dict(d["task"], n_query_init=n_query, attend_to=attend_to)
    d["encoder"] = dict(d["encoder"], attention_impl=attention)
    return tcfg.config_from_dict(d)


def _train_epochs(cfg, n, graphed):
    """``n`` epochs of a trainer from the config's seed, through the graphs
    or (``graphed`` False) through ``train/rollout.py``'s eager steps:
    [(metrics, gradients, parameters)] after each, the masks drawn, and
    the calls that captured and replayed."""
    import logging

    from aline_tpu_torch.train import loop
    from aline_tpu_torch.train import rollout as eager
    tr = loop.Trainer(cfg, logger=logging.getLogger("test_torch_cuda"),
                      device="cuda")
    orig = loop.rollout
    masks = []

    def spy(model, batch, *a, **kw):
        masks.append(tuple(batch.target_mask.tolist()))
        return (orig if graphed else eager.rollout)(model, batch, *a, **kw)

    loop.rollout = spy
    metrics.set_tracing(True)
    try:
        out = []
        for e in range(n):
            m = tr.train_epoch(e)
            out.append(({k: torch.as_tensor(v).clone() for k, v in m.items()},
                        {k: p.grad.clone()
                         for k, p in tr.model.named_parameters()},
                        {k: p.detach().clone()
                         for k, p in tr.model.named_parameters()}))
        spans = metrics.collect()
    finally:
        loop.rollout = orig
        metrics.set_tracing(False)
        metrics.collect()
    counts = tuple(sum(s.counts.get(c, 0) for s in spans)
                   for c in ("train.graph_captures", "train.graph_replays"))
    return out, masks, counts


@pytest.mark.parametrize("attention", ["compact", "flash"])
@pytest.mark.parametrize("attend_to", ["data", "theta", None])
def test_graphed_training_equals_eager_bitwise(cuda, tmp_path, attention,
                                               attend_to):
    """From one state, epochs through the graph path against eager epochs:
    the losses, gradients and parameters bit for bit (None: the fair coin,
    so that two keys under compact take turns in one pool)."""
    n = 4 if attend_to else 6
    cfg = _train_cfg(tmp_path, attention, attend_to)
    got, masks, (captures, replays) = _train_epochs(cfg, n, True)
    want, want_masks, eager_counts = _train_epochs(cfg, n, False)
    assert masks == want_masks
    assert eager_counts == (0, 0)
    variants = len(set(masks))
    assert variants == (1 if attend_to else 2)
    keys = 1 if attention == "flash" else variants
    # a key's first epoch eager, its second captures and replays
    assert (captures, replays) == (keys, n - keys)
    for e, (g, w) in enumerate(zip(got, want)):
        for part, name in zip(range(3), ("metrics", "grads", "params")):
            for k in w[part]:
                assert torch.equal(g[part][k], w[part][k]), (e, name, k)


def test_graphed_flash_epoch_counts_its_launches(cuda, tmp_path):
    """A replayed flash epoch at T=30 counts what an eager one counts: 60
    plans, 180 forwards (90 under train.backward), 90 backwards, in the
    counters and in ``LAUNCHES``; its designs are the rollout's own."""
    import logging

    from aline_tpu_torch.train import loop
    from aline_tpu_torch.train import rollout as eager
    from aline_tpu_torch.utils.graphs import counted_apart
    cfg = _train_cfg(tmp_path, "flash", "data", B=8, T=30, n_query=50)
    tr = loop.Trainer(cfg, logger=logging.getLogger("test_torch_cuda"),
                      device="cuda")
    tr.train_epoch(0)                        # eager
    tr.train_epoch(1)                        # the capture and a replay
    orig, calls = loop.rollout, []

    def spy(*a, **kw):
        ro = orig(*a, **kw)
        # the eager reference before the update moves the model, its
        # launches and counts kept out of the epoch's
        with torch.no_grad(), counted_apart():
            calls.append((ro, eager.rollout(*a, **kw)))
        return ro

    before = dict(_build.LAUNCHES)
    loop.rollout = spy
    metrics.set_tracing(True)
    try:
        tr.train_epoch(2)
        torch.cuda.synchronize()
        spans = metrics.collect()
    finally:
        loop.rollout = orig
        metrics.set_tracing(False)
        metrics.collect()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                if v != before[k]}
    assert launched == {"flash_plan": 60, "flash_attn_fwd_bf16": 180,
                        "flash_attn_bwd_bf16": 90}

    def total(name, where=None):
        return sum(s.counts.get(name, 0) for s in spans
                   if where is None or s.name == where)

    assert (total("train.graph_captures"), total("train.graph_replays")) \
        == (0, 1)
    assert [total(c) for c in ("flash.plan", "flash.fwd", "flash.bwd")] \
        == [60, 180, 90]
    assert [total(c, "train.backward")
            for c in ("flash.plan", "flash.fwd", "flash.bwd")] == [30, 90, 90]
    (ro, want), = calls
    assert torch.equal(ro.idx, want.idx)
    assert torch.equal(ro.nll_pred, want.nll_pred)
