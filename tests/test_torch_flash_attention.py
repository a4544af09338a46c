"""The port's role-masked flash attention (``aline_tpu_torch.ops.
flash_attention``, its plain versions on the CPU) against the JAX Pallas
kernel in interpret mode, from the same numpy inputs.

Tolerances, as ``tests/test_flash_attention.py`` holds the JAX kernel to
the dense path: forward (O and lse) rtol = atol = 2e-5, float32 on both
sides with only the summation order differing; gradients rtol 5e-4, atol
5e-5, where the backward's products sum N terms in another order.  The
role codes are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aline_tpu.ops import flash_attention as jfa
from aline_tpu.ops import roles as jroles
from aline_tpu_torch.ops import flash_attention as tfa
from aline_tpu_torch.ops import roles as troles

torch.set_num_threads(1)

# (B, H, n_points, n_target, dh, with_time, masked): ``masked`` empties
# the context and the target mask of batch row 1, so every row there sees
# no key (without a time token) or only the time column (query rows).
CASES = {
    "dh8": (2, 2, 12, 5, 8, False, False),
    "dh8 time": (2, 2, 12, 5, 8, True, False),
    "N37 ragged time": (1, 2, 30, 6, 16, True, False),
    "dh64 time": (1, 2, 20, 7, 64, True, False),
    "fully masked": (2, 2, 9, 3, 8, False, True),
    "fully masked time": (2, 2, 9, 3, 8, True, True),
}


def _inputs(case, seed=0):
    B, H, P, nt, dh, with_time, masked = CASES[case]
    rng = np.random.default_rng(seed)
    ctx = rng.random((B, P)) < 0.4
    ctx[:, 0] = True
    tmask = rng.random(nt) < 0.5
    tmask[0] = True
    if masked:
        ctx[1] = False
        tmask[:] = False
    N = int(with_time) + P + nt
    q, k, v, w = (rng.normal(size=(B, H, N, dh)).astype(np.float32)
                  for _ in range(4))
    return ctx, tmask, with_time, q, k, v, w


def _codes(ctx, tmask, with_time):
    """(JAX codes, port codes) from the same flags."""
    jr = jroles.build_roles(jnp.asarray(ctx), tmask.size, jnp.asarray(tmask),
                            with_time)
    tr = troles.build_roles(torch.from_numpy(ctx), tmask.size,
                            torch.from_numpy(tmask), with_time)
    return jfa.roles_to_codes(jr), troles.roles_to_codes(tr)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("case", ["dh8 time", "fully masked time"])
def test_roles_and_codes_match_jax(case):
    ctx, tmask, with_time, *_ = _inputs(case)
    jr = jroles.build_roles(jnp.asarray(ctx), tmask.size, jnp.asarray(tmask),
                            with_time)
    tr = troles.build_roles(torch.from_numpy(ctx), tmask.size,
                            torch.from_numpy(tmask), with_time)
    for name in troles.Roles._fields:
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)
    np.testing.assert_array_equal(troles.attention_bias(tr).numpy(),
                                  np.asarray(jroles.attention_bias(jr)))
    (jk, jq), (tk, tq) = _codes(ctx, tmask, with_time)
    assert tk.dtype == tq.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    if with_time:
        assert (tk[:, 0] == 2).all()       # the time column: query rows see it


def test_block_q_and_padding_match_jax():
    for N in list(range(1, 300)) + [2103, 2048, 4097]:
        assert tfa.block_q(N) == jfa._block_q(N), N
        bq = jfa._block_q(N)
        assert tfa.padded_len(N) == -(-N // bq) * bq, N


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_kernel(case):
    ctx, tmask, with_time, q, k, v, _ = _inputs(case)
    (jk, jq), (tk, tq) = _codes(ctx, tmask, with_time)
    want_o, res = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), jk, jq, True)
    o, lse = tfa.flash_attn_fwd(_t(q), _t(k), _t(v), tk, tq)
    _close(o, want_o, 2e-5, 2e-5, "O")
    _close(lse, res[-1], 2e-5, 2e-5, "lse")
    got = tfa.flash_role_attention(_t(q), _t(k), _t(v), tk, tq)
    _close(got, jfa.flash_role_attention(*map(jnp.asarray, (q, k, v)), jk, jq,
                                         True), 2e-5, 2e-5, "entry")


@pytest.mark.parametrize("case", ["fully masked", "fully masked time"])
def test_fully_masked_rows_average_over_the_padded_length(case):
    """A row that sees no key averages v over Np columns, as the TPU
    kernel does, not over N as the dense softmax would."""
    ctx, tmask, with_time, q, k, v, _ = _inputs(case)
    _, (kcode, qrow) = _codes(ctx, tmask, with_time)
    o, lse = tfa.flash_attn_fwd(_t(q), _t(k), _t(v), kcode, qrow)
    allowed = ((kcode[:, None, :] == 1)
               | ((qrow[:, :, None] == 1) & (kcode[:, None, :] == 2)))
    blind = ~allowed.any(dim=-1)                            # [B, N]
    assert blind[1].any() and not blind[0].any()
    N = q.shape[2]
    Np = tfa.padded_len(N)
    assert Np > N
    mean_np = _t(v).sum(dim=2, keepdim=True) / Np           # [B, H, 1, dh]
    b, i = torch.nonzero(blind, as_tuple=True)
    _close(o[b, :, i], mean_np[b, :, 0], 1e-6, 1e-6)
    assert (lse[b, :, i] == -1e9).all()


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_custom_vjp(case):
    ctx, tmask, with_time, q, k, v, w = _inputs(case, seed=1)
    (jk, jq), (tk, tq) = _codes(ctx, tmask, with_time)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_role_attention(q, k, v, jk, jq, True)
                       * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    (tfa.flash_role_attention(*leaves, tk, tq) * _t(w)).sum().backward()
    for leaf, g, name in zip(leaves, want, "qkv"):
        _close(leaf.grad, g, 5e-4, 5e-5, f"d{name}")


@pytest.mark.parametrize("case", ["dh8 time", "N37 ragged time",
                                  "dh64 time"])
def test_autograd_function_matches_autograd_of_plain_forward(case):
    """Where every row sees a key, the hand-written backward is the
    gradient of the forward.  (A row that sees none gets the TPU kernel's
    P = exp(s - lse) on masked columns, which autograd of the replaced
    scores does not give; the JAX test above covers it.)"""
    ctx, tmask, with_time, q, k, v, w = _inputs(case, seed=2)
    _, (tk, tq) = _codes(ctx, tmask, with_time)
    got = [_t(a).requires_grad_() for a in (q, k, v)]
    (tfa.flash_role_attention(*got, tk, tq) * _t(w)).sum().backward()
    ref = [_t(a).requires_grad_() for a in (q, k, v)]
    (tfa.flash_attn_fwd_plain(*ref, tk, tq)[0] * _t(w)).sum().backward()
    for a, b, name in zip(got, ref, "qkv"):
        _close(a.grad, b.grad, 5e-4, 5e-5, f"d{name}")


def test_no_grad_call_saves_nothing_and_codes_get_no_gradient():
    ctx, tmask, with_time, q, k, v, _ = _inputs("dh8 time")
    _, (tk, tq) = _codes(ctx, tmask, with_time)
    qt = _t(q).requires_grad_()
    with torch.no_grad():
        assert tfa.flash_role_attention(qt, _t(k), _t(v), tk,
                                        tq).grad_fn is None
    out = tfa.flash_role_attention(qt, _t(k), _t(v), tk, tq)
    assert out.grad_fn is not None
    out.sum().backward()
    assert qt.grad is not None and tk.grad is None


def test_wrappers_check_their_inputs():
    ctx, tmask, with_time, q, k, v, _ = _inputs("dh8")
    _, (tk, tq) = _codes(ctx, tmask, with_time)
    q, k, v = _t(q), _t(k), _t(v)
    with pytest.raises(TypeError):
        tfa.flash_attn_fwd(q.double(), k, v, tk, tq)
    with pytest.raises(TypeError):
        tfa.flash_attn_fwd(q, k, v, tk.long(), tq)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attn_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, tk, tq)
    with pytest.raises(ValueError, match="shape"):
        tfa.flash_attn_fwd(q, k[:, :, :-1], v, tk, tq)
    o, lse = tfa.flash_attn_fwd(q, k, v, tk, tq)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attn_bwd(q, k, v, tk, tq, o, lse[..., :-1], o)
