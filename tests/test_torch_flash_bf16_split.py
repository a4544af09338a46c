"""The arithmetic of the port's bfloat16 flash-attention kernels, emulated
in numpy, against the JAX package's flash attention in bfloat16.

``csrc/flash_attn_{fwd,bwd}.cu`` run their bfloat16 forms on the bf16
tensor cores (``csrc/flash_attn_mma.cuh``).  The scores q·kᵀ and dP = dO·vᵀ
are products of two bfloat16 operands, exact in float32, summed in float32.
P and dS are float32: each is split into three bfloat16 pieces by clearing
low bits (``split``: x0 is x with its low 16 bits cleared, x1 the same of
x - x0, x2 the rest), x0 + x1 + x2 == x exactly, and a piece times a
bfloat16 value is again exact in float32, so the three products summed in
float32 give the float32 product up to the order of the sums.  Scores are
kept in log2 units (the scale times log2 e, exp2), a masked pair scores
-1e9 · log2 e, and lse is m · ln 2 + log(l) (-1e9 + log(l) for a row that
sees no key).  The emulation below follows those steps: float32 matmuls of
exactly representable operands stand for the tensor cores' products.

It is held to ``flash_role_attention`` run in interpret mode and to its
VJP, as tests/test_torch_bf16.py holds the plain versions, at that file's
limits: O within 1 ulp in at most 0.1% of the elements, lse within 2e-5,
dQ, dK and dV within 1 ulp in at most 0.5% of the elements or 1e-5 of the
gradient's largest element (dK and dV summed into bfloat16 block by block
of ``block_q(N)`` rows, as the TPU kernel sums them; the kernels' own sum
over all rows is held to the plain version by tests/test_torch_bf16.py
and on the card).  P·V, dS·K and the rest from a single bfloat16 piece
miss those limits: that is why the kernels split.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu.ops import flash_attention as jfa
from aline_tpu_torch.ops import flash_attention as tfa
from test_torch_bf16 import FLASH_CASES, _flash_inputs, assert_ulps

F32 = np.float32
LOG2E = F32(1.4426950408889634)
LN2 = F32(0.6931471805599453)
NEG = F32(-1e9)
NEG2 = NEG * LOG2E        # a masked score in log2 units, as the kernels
HIGH = np.uint32(0xFFFF0000)


def split(x, pieces=3):
    """The bfloat16 pieces of float32 x, largest first (as float32)."""
    out, r = [], np.asarray(x, F32)
    for _ in range(pieces):
        h = (r.view(np.uint32) & HIGH).view(F32)
        out.append(h)
        r = (r - h).astype(F32)
    return out


def split_matmul(a, b, pieces=3):
    """a @ b with a float32 and b bfloat16-valued: the pieces' products
    (each exact) summed into one float32 accumulator, smallest first."""
    acc = None
    for part in reversed(split(a, pieces)):
        prod = np.matmul(part, b, dtype=F32)
        acc = prod if acc is None else (acc + prod).astype(F32)
    return acc


def _bf16(x):
    return np.asarray(x, F32).astype(jnp.bfloat16)


def _allowed(kcode, qrow):
    kc = kcode[:, None, None, :]
    return (kc == 1) | ((qrow[:, None, :, None] == 1) & (kc == 2))


def _log2_scores(q, k, kcode, qrow):
    """[B, H, N, N] float32 scores in log2 units, masked ones replaced."""
    c2 = F32(1.0 / np.sqrt(q.shape[-1])) * LOG2E
    d = np.matmul(q, np.swapaxes(k, -1, -2), dtype=F32)
    return np.where(_allowed(kcode, qrow), (d * c2).astype(F32), NEG2)


def emulated_fwd(q, k, v, kcode, qrow, pieces=3):
    """(O bfloat16, lse float32) as the bfloat16 forward kernel computes
    them; q, k, v float32 arrays of bfloat16 values."""
    N = q.shape[2]
    n_pad = tfa.padded_len(N) - N
    s = _log2_scores(q, k, kcode, qrow)
    m = s.max(axis=-1, keepdims=True)        # the padded columns score NEG2
    p = np.exp2(s - m).astype(F32)
    l = (p.sum(axis=-1, keepdims=True, dtype=F32)
         + F32(n_pad) * np.exp2(NEG2 - m)).astype(F32)
    o = _bf16(split_matmul(p, v, pieces) / l)
    lse = np.where(m == NEG2, NEG + np.log(l), m * LN2 + np.log(l))
    return o, lse[..., 0].astype(F32)


def emulated_bwd(q, k, v, kcode, qrow, o, lse, do, pieces=3):
    """(dQ, dK, dV) bfloat16 as the bfloat16 backward kernels compute
    them, but with dK and dV summed into bfloat16 block by block of
    ``block_q(N)`` rows, as the TPU kernel sums them."""
    N, dh = q.shape[2], q.shape[3]
    scale = F32(1.0 / np.sqrt(dh))
    lse2 = (lse * LOG2E).astype(F32)[..., None]
    p = np.exp2(_log2_scores(q, k, kcode, qrow) - lse2).astype(F32)
    dp = np.matmul(do, np.swapaxes(v, -1, -2), dtype=F32)
    delta = _bf16((do * o).sum(axis=-1, keepdims=True, dtype=F32))
    ds = (p * (dp - delta.astype(F32))).astype(F32)
    dq = _bf16(split_matmul(ds, k, pieces) * scale)
    dk = np.zeros(q.shape, jnp.bfloat16)
    dv = np.zeros(q.shape, jnp.bfloat16)
    bq = tfa.block_q(N)
    for i in range(0, N, bq):
        rows = slice(i, i + bq)
        pt = np.swapaxes(p[:, :, rows], -1, -2)
        dst = np.swapaxes(ds[:, :, rows], -1, -2)
        dv = _bf16(dv.astype(F32) + _bf16(
            split_matmul(pt, do[:, :, rows], pieces)).astype(F32))
        dk = _bf16(dk.astype(F32) + _bf16(
            split_matmul(dst, q[:, :, rows], pieces) * scale).astype(F32))
    return dq, dk, dv


def _t(a):
    return torch.from_numpy(np.asarray(a, F32)).to(torch.bfloat16)


def _inputs(case, seed):
    (jk, jq), (tk, tq), q, k, v, w = _flash_inputs(case, seed=seed)
    return (jk, jq), (tk.numpy(), tq.numpy()), [
        np.asarray(x, F32) for x in (q, k, v, w)]


def _jax_fwd(q, k, v, jk, jq):
    args = tuple(jnp.asarray(_bf16(x)) for x in (q, k, v))
    o = jfa.flash_role_attention(*args, jk, jq, True)
    _, res = jfa._flash_fwd(*args, jk, jq, True)
    return o, np.asarray(res[-1])


def _jax_vjp(q, k, v, w, jk, jq):
    args = tuple(jnp.asarray(_bf16(x)) for x in (q, k, v))
    o, vjp = jax.vjp(lambda a, b, c: jfa.flash_role_attention(
        a, b, c, jk, jq, True), *args)
    _, res = jfa._flash_fwd(*args, jk, jq, True)
    return o, np.asarray(res[-1]), vjp(jnp.asarray(_bf16(w)))


def _within(assertion):
    try:
        assertion()
    except AssertionError:
        return False
    return True


def test_split_is_exact_in_three_bfloat16_pieces():
    rng = np.random.default_rng(0)
    # softmax weights exp2(s - m) and dS = P (dP - D) over many magnitudes
    x = np.concatenate([
        np.exp2(-rng.random(20000) * 60).astype(F32),
        (rng.normal(size=20000) * 10.0 ** rng.integers(-12, 3, 20000))
        .astype(F32), np.array([1.0, -1.0, 0.0, 2.0 ** -100], F32)])
    parts = split(x)
    for part in parts:                      # each a bfloat16 value
        assert not (part.view(np.uint32) & ~HIGH).any()
    assert np.array_equal((parts[0] + parts[1]).astype(F32) + parts[2], x)
    # each piece times a bfloat16 value is exact in float32
    b = _bf16(rng.normal(size=x.size)).astype(F32)
    for part in parts:
        prod = part * b
        assert np.array_equal(prod.astype(np.float64),
                              part.astype(np.float64) * b)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_split_forward_matches_jax_interpret(case):
    (jk, jq), (kc, qr), (q, k, v, _) = _inputs(case, seed=0)
    want_o, want_lse = _jax_fwd(q, k, v, jk, jq)
    o, lse = emulated_fwd(q, k, v, kc, qr)
    assert_ulps(_t(o), want_o, 0.001, "O")
    np.testing.assert_allclose(lse, want_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_split_backward_matches_jax_vjp(case):
    (jk, jq), (kc, qr), (q, k, v, w) = _inputs(case, seed=1)
    o, lse, want = _jax_vjp(q, k, v, w, jk, jq)
    got = emulated_bwd(q, k, v, kc, qr, np.asarray(o, F32), lse, w)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert_ulps(_t(g), r, 0.005, name, floor=1e-5)


@pytest.mark.parametrize("case", ["N303 three blocks", "N300 blind dh32"])
def test_one_bfloat16_piece_misses_the_limits(case):
    # the inputs of the two tests above (and of tests/test_torch_bf16.py)
    (jk, jq), (kc, qr), (q, k, v, _) = _inputs(case, seed=0)
    want_o, _ = _jax_fwd(q, k, v, jk, jq)
    for pieces, ok in ((1, False), (3, True)):
        o, _ = emulated_fwd(q, k, v, kc, qr, pieces)
        assert _within(lambda: assert_ulps(_t(o), want_o, 0.001)) == ok
    (jk, jq), (kc, qr), (q, k, v, w) = _inputs(case, seed=1)
    o, lse, want = _jax_vjp(q, k, v, w, jk, jq)
    for pieces, ok in ((1, False), (3, True)):
        got = emulated_bwd(q, k, v, kc, qr, np.asarray(o, F32), lse, w,
                           pieces)
        held = [_within(lambda: assert_ulps(_t(g), r, 0.005, floor=1e-5))
                for g, r in zip(got, want)]
        assert all(held) == ok, held
