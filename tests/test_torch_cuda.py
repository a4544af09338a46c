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
"""
import pytest
import torch

from aline_tpu_torch.ops import flash_attention as fa
from aline_tpu_torch.ops import gmm_head_kernel as ghk
from aline_tpu_torch.ops.roles import build_roles, roles_to_codes

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


@pytest.mark.parametrize("F", [36, 264])
def test_gmm_head_kernels_refuse_an_f_they_do_not_take(cuda, F):
    """Every F ≥ 1 is taken, as the Pallas kernels take it: 36 and 264
    run zero-padded (to 40 on the narrow kernel; to D=128, F=384 on the
    tiled one) and launch the kernels; F=0 is refused, with no launch and
    no fallback."""
    z, w1, b1, w2, b2 = _inputs(2, 9, 32, F, 4, grid=True)
    g = torch.randn(2, 9, 4, 3, device="cuda")
    before = dict(ghk.LAUNCHES)
    torch.testing.assert_close(ghk.gmm_head_fwd(z, w1, b1, w2, b2),
                               ghk.gmm_head_fwd_plain(z, w1, b1, w2, b2),
                               rtol=TOL, atol=TOL)
    for name, a, b in zip(("dz", "dw1", "db1", "dw2", "db2"),
                          ghk.gmm_head_bwd(z, w1, b1, w2, g),
                          ghk.gmm_head_bwd_plain(z, w1, b1, w2, g)):
        assert a.shape == b.shape, name
        _assert_grad_close(a, b, name)
    assert ghk.LAUNCHES["gmm_head_fwd"] == before["gmm_head_fwd"] + 1
    assert ghk.LAUNCHES["gmm_head_bwd"] == before["gmm_head_bwd"] + 1
    w1, b1, w2 = (torch.empty(*shape, device="cuda")      # F=0
                  for shape in ((4, 32, 0), (4, 0), (4, 0, 3)))
    before = dict(ghk.LAUNCHES)
    with pytest.raises(ValueError, match="F"):
        ghk.gmm_head_fwd(z, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="F"):
        ghk.gmm_head_bwd(z, w1, b1, w2, g)
    assert ghk.LAUNCHES == before


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
    before = fa.LAUNCHES["flash_attn_fwd"]
    o, lse = fa.flash_attn_fwd(q, k, v, kcode, qrow)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attn_fwd"] == before + 1
    want_o, want_lse = fa.flash_attn_fwd_plain(q, k, v, kcode, qrow)
    torch.testing.assert_close(o, want_o, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, want_lse, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_backward_kernel_matches_plain(cuda, shape):
    q, k, v, kcode, qrow, do = _flash_inputs(*shape, seed=1)
    o, lse = fa.flash_attn_fwd_plain(q, k, v, kcode, qrow)
    before = fa.LAUNCHES["flash_attn_bwd"]
    got = fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attn_bwd"] == before + 1
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
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attn_fwd(q, k, v, kcode, qrow)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attn_fwd_bf16"] == \
        before["flash_attn_fwd_bf16"] + 1
    assert fa.LAUNCHES["flash_attn_fwd"] == before["flash_attn_fwd"]
    want_o, want_lse = fa.flash_attn_fwd_plain(q, k, v, kcode, qrow)
    _assert_bf16_close(o, want_o, 1e-5, "O")
    torch.testing.assert_close(lse, want_lse, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", BF16_BWD_SHAPES)
def test_bf16_flash_backward_kernel_matches_plain(cuda, shape):
    q, k, v, kcode, qrow, do = _flash_inputs(*shape, seed=1)
    q, k, v, do = _bf16(q, k, v, do)
    o, lse = fa.flash_attn_fwd_plain(q, k, v, kcode, qrow)
    before = fa.LAUNCHES["flash_attn_bwd_bf16"]
    got = fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attn_bwd_bf16"] == before + 1
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
    before = dict(fa.LAUNCHES)
    out = fa.flash_role_attention(*leaves, kcode, qrow)
    out.backward(do.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)
    for name in ("flash_attn_fwd_bf16", "flash_attn_bwd_bf16"):
        assert fa.LAUNCHES[name] == before[name] + 1, name
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
    before = dict(fa.LAUNCHES)
    fa.flash_role_attention(*leaves, kcode, qrow).backward(do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attn_fwd"] == before["flash_attn_fwd"] + 1
    assert fa.LAUNCHES["flash_attn_bwd"] == before["flash_attn_bwd"] + 1
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
    before = fa.LAUNCHES["flash_plan"]
    plan = fa.flash_plan(kcode, qrow)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_plan"] == before + 1
    for name, a, b in zip(fa.FlashPlan._fields, plan,
                          fa.flash_plan_plain(kcode, qrow)):
        assert torch.equal(a, b), name


def test_flash_kernels_take_a_given_plan(cuda):
    """A plan passed in is the one the kernels walk: no second plan, and
    the same results as with the plan they build themselves."""
    q, k, v, kcode, qrow, do = _flash_inputs(16, 4, 201, 102, 8, True, True)
    plan = fa.flash_plan(kcode, qrow)
    before = fa.LAUNCHES["flash_plan"]
    o, lse = fa.flash_attn_fwd(q, k, v, kcode, qrow, plan)
    got = fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do, plan)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_plan"] == before
    o2, lse2 = fa.flash_attn_fwd(q, k, v, kcode, qrow)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b in zip(got, fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="plan"):
        fa.flash_attn_fwd(q, k, v, kcode, qrow, plan._replace(
            key_perm=plan.key_perm[:-1]))
