"""The plan of the role mask (``aline_tpu_torch.ops.flash_attention.
flash_plan``) and the flash kernels' walks over it, on the CPU.

* The plain plan (what the CPU runs, and what ``csrc/flash_plan.cu`` must
  equal bitwise on the card) against an independent loop over the tokens,
  and against its invariants: each permutation is a permutation, the
  groups come in order and each group in index order, the counts, and
  ``dense``.  Exact.
* A torch emulation of the CUDA kernels' loops over the plan (forward, dQ
  pass, dK/dV pass): rows (or key columns) in blocks taken in plan order,
  each block walking as far as its first member does (a query row the
  first n_vis keys of key_perm, any other row n_ctx; a context key all N
  rows, a code-2 key the n_query query rows, a code-0 key none; all N in a
  dense batch row).  Held to the dense plain versions and to the JAX
  Pallas kernel in interpret mode and its custom VJP, from the same numpy
  inputs: forward rtol = atol = 2e-5, gradients rtol 5e-4, atol 5e-5, as
  in ``tests/test_torch_flash_attention.py``.
* One ``Encoder`` forward and backward with ``attention_impl=flash``: one
  plan for every layer and head, and the emulated kernels driven by it
  give the plain path's outputs and gradients.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aline_tpu.ops import flash_attention as jfa
from aline_tpu_torch.config import EncoderConfig
from aline_tpu_torch.models import encoder as tenc
from aline_tpu_torch.ops import flash_attention as tfa
from aline_tpu_torch.ops import roles as troles
from test_torch_flash_attention import CASES, _close, _codes, _inputs, _t

torch.set_num_threads(1)


def _port_codes(ctx, tmask, with_time):
    return troles.roles_to_codes(troles.build_roles(
        torch.from_numpy(ctx), tmask.size, torch.from_numpy(tmask),
        with_time))


def _reference_plan(kcode, qrow):
    """The plan by a loop over the tokens: each group's indices, in order."""
    key_perm, row_perm, counts = [], [], []
    for kc, qr in zip(kcode.tolist(), qrow.tolist()):
        ctx = [j for j, c in enumerate(kc) if c == 1]
        extra = [j for j, c in enumerate(kc) if c == 2]
        rest = [j for j, c in enumerate(kc) if c not in (1, 2)]
        query = [i for i, f in enumerate(qr) if f == 1]
        other = [i for i, f in enumerate(qr) if f != 1]
        key_perm.append(ctx + extra + rest)
        row_perm.append(query + other)
        # a row that sees no key: allowed(i, j) false for every j
        blind = any(not any(c == 1 or (f == 1 and c == 2) for c in kc)
                    for f in qr)
        counts.append((len(ctx), len(ctx) + len(extra), len(query),
                       int(blind)))
    n_ctx, n_vis, n_query, dense = zip(*counts)
    return [torch.tensor(x, dtype=torch.int32).reshape(len(kcode), -1)
            for x in (key_perm, row_perm)] + [
        torch.tensor(x, dtype=torch.int32)
        for x in (n_ctx, n_vis, n_query, dense)]


def _assert_plan(kcode, qrow):
    plan = tfa.flash_plan(kcode, qrow)
    assert isinstance(plan, tfa.FlashPlan)
    B, N = kcode.shape
    for name, got, want in zip(tfa.FlashPlan._fields, plan,
                               _reference_plan(kcode, qrow)):
        assert got.dtype == torch.int32, name
        assert torch.equal(got, want), name
    ar = torch.arange(N)
    for b in range(B):
        kp, rp = plan.key_perm[b].long(), plan.row_perm[b].long()
        assert torch.equal(kp.sort().values, ar)             # permutations
        assert torch.equal(rp.sort().values, ar)
        nc, nv, nq = (int(t[b]) for t in (plan.n_ctx, plan.n_vis,
                                          plan.n_query))
        codes = kcode[b, kp]
        assert (codes[:nc] == 1).all() and (codes[nc:nv] == 2).all()
        assert ((codes[nv:] != 1) & (codes[nv:] != 2)).all()
        assert (qrow[b, rp[:nq]] == 1).all() and (qrow[b, rp[nq:]] != 1).all()
        for perm, cuts in ((kp, (0, nc, nv, N)), (rp, (0, nq, N))):
            for lo, hi in zip(cuts[:-1], cuts[1:]):       # index order
                group = perm[lo:hi]
                assert (group[1:] > group[:-1]).all()
    return plan


@pytest.mark.parametrize("case", list(CASES))
def test_plain_plan_on_the_attention_cases(case):
    ctx, tmask, with_time, *_ = _inputs(case)
    kcode, qrow = _port_codes(ctx, tmask, with_time)
    plan = _assert_plan(kcode, qrow)
    if CASES[case][-1]:       # batch row 1 has no context: blind rows
        assert plan.dense.tolist() == [0, 1]
    else:
        assert not plan.dense.any()


@pytest.mark.parametrize("n_ctx", [0, 1, 7, 31, 60])
def test_plain_plan_on_scattered_contexts(n_ctx):
    """Context points flipped anywhere in the pool, as the rollout does."""
    rng = np.random.default_rng(n_ctx)
    B, P, nt = 3, 60, 9
    ctx = np.zeros((B, P), bool)
    for b in range(B):
        ctx[b, rng.choice(P, n_ctx, replace=False)] = True
    tmask = rng.random(nt) < 0.5
    for with_time in (False, True):
        plan = _assert_plan(*_port_codes(ctx, tmask, with_time))
        # no context: a target row sees no key; every query row sees the
        # time column or a selected target, if any
        assert plan.dense.tolist() == [int(n_ctx == 0)] * B


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_plain_plan_on_drawn_flags(data):
    B = data.draw(st.integers(1, 3))
    P = data.draw(st.integers(1, 20))
    nt = data.draw(st.integers(0, 6))
    with_time = data.draw(st.booleans())
    ctx = np.array(data.draw(st.lists(st.booleans(), min_size=B * P,
                                      max_size=B * P))).reshape(B, P)
    tmask = np.array(data.draw(st.lists(st.booleans(), min_size=nt,
                                        max_size=nt)), dtype=bool)
    _assert_plan(*_port_codes(ctx, tmask, with_time))


def test_plan_checks_its_inputs():
    kcode = torch.zeros(2, 5, dtype=torch.int32)
    with pytest.raises(TypeError):
        tfa.flash_plan(kcode.long(), kcode)
    with pytest.raises(ValueError, match="shape"):
        tfa.flash_plan(kcode, kcode[:, :4])
    empty = tfa.flash_plan(kcode[:, :0].contiguous(), kcode[:, :0].contiguous())
    assert empty.key_perm.shape == (2, 0) and empty.n_ctx.tolist() == [0, 0]


# -- the kernels' walks over the plan, emulated ------------------------------

def _walks(plan, b):
    """(code of each key position, keys a row position walks, rows a key
    position walks) for batch row b, as csrc/flash_attn_common.cuh."""
    nc, nv, nq, dense = (int(t[b]) for t in (plan.n_ctx, plan.n_vis,
                                             plan.n_query, plan.dense))
    N = plan.key_perm.shape[1]
    pos = torch.arange(N)
    code = torch.where(pos < nc, 1, torch.where(pos < nv, 2, 0))
    keys_for = (torch.full((N,), N) if dense
                else torch.where(pos < nq, nv, nc))
    rows_for = (torch.full((N,), N) if dense
                else torch.where(pos < nc, N, torch.where(pos < nv, nq, 0)))
    return code, keys_for, rows_for, nq


def emulate_fwd(q, k, v, plan, n_pad, block):
    """The forward kernel's walk: blocks of ``block`` row positions, each
    over the first keys_for(first row) keys of key_perm."""
    B, H, N, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    o, lse = torch.empty_like(q), torch.empty(B, H, N)
    for b in range(B):
        code, keys_for, _, nq = _walks(plan, b)
        kp, rp = plan.key_perm[b].long(), plan.row_perm[b].long()
        for r0 in range(0, N, block):
            rows = rp[r0:r0 + block]
            keys = kp[:int(keys_for[r0])]
            is_q = torch.arange(r0, r0 + len(rows)) < nq
            kc = code[:len(keys)]
            allowed = (kc == 1) | (is_q[:, None] & (kc == 2))
            s = torch.where(allowed, q[b, :, rows] @ k[b, :, keys].mT * scale,
                            tfa.NEG)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(dim=-1, keepdim=True) + n_pad * torch.exp(tfa.NEG - m)
            o[b, :, rows] = p @ v[b, :, keys] / l
            lse[b, :, rows] = (m + torch.log(l))[..., 0]
    return o, lse


def emulate_bwd(q, k, v, o, lse, do, plan, block):
    """The dQ pass (row blocks, key walks as the forward) and the dK/dV
    pass (blocks of key positions, each over the first rows_for(first
    key) rows of row_perm; a block that walks none writes zeros)."""
    B, H, N, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    delta = (do * o).sum(dim=-1)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    for b in range(B):
        code, keys_for, rows_for, nq = _walks(plan, b)
        kp, rp = plan.key_perm[b].long(), plan.row_perm[b].long()
        for r0 in range(0, N, block):
            rows = rp[r0:r0 + block]
            keys = kp[:int(keys_for[r0])]
            is_q = torch.arange(r0, r0 + len(rows)) < nq
            kc = code[:len(keys)]
            allowed = (kc == 1) | (is_q[:, None] & (kc == 2))
            s = torch.where(allowed, q[b, :, rows] @ k[b, :, keys].mT * scale,
                            tfa.NEG)
            p = torch.exp(s - lse[b, :, rows, None])
            dp = do[b, :, rows] @ v[b, :, keys].mT
            ds = p * (dp - delta[b, :, rows, None])
            dq[b, :, rows] = ds @ k[b, :, keys] * scale
        for p0 in range(0, N, block):
            cols = kp[p0:p0 + block]
            n_rows = int(rows_for[p0])
            if n_rows == 0:
                continue                                   # dK = dV = 0
            rows = rp[:n_rows]
            kc = code[p0:p0 + len(cols)]
            is_q = torch.arange(n_rows) < nq
            allowed = (kc[:, None] == 1) | ((kc[:, None] == 2) & is_q[None])
            s = torch.where(allowed, k[b, :, cols] @ q[b, :, rows].mT * scale,
                            tfa.NEG)
            p = torch.exp(s - lse[b, :, None, rows])
            dv[b, :, cols] = p @ do[b, :, rows]
            dp = v[b, :, cols] @ do[b, :, rows].mT
            ds = p * (dp - delta[b, :, None, rows])
            dk[b, :, cols] = ds @ q[b, :, rows] * scale
    return dq, dk, dv


def _kernel_block(dh):
    """Rows per CTA of the CUDA kernels: 128 threads, dh/16 lanes a row."""
    return 128 // max(1, dh // 16)


@pytest.mark.parametrize("block", ["row", "kernel"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_walks_match_plain_and_jax_kernel(case, block):
    ctx, tmask, with_time, q, k, v, w = _inputs(case, seed=3)
    (jk, jq), (tk, tq) = _codes(ctx, tmask, with_time)
    N, dh = q.shape[2], q.shape[3]
    blk = 1 if block == "row" else _kernel_block(dh)
    plan = tfa.flash_plan(tk, tq)
    qt, kt, vt, wt = map(_t, (q, k, v, w))
    o, lse = emulate_fwd(qt, kt, vt, plan, tfa.padded_len(N) - N, blk)
    po, plse = tfa.flash_attn_fwd_plain(qt, kt, vt, tk, tq)
    _close(o, po, 2e-5, 2e-5, "O vs plain")
    _close(lse, plse, 2e-5, 2e-5, "lse vs plain")
    jo, res = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), jk, jq, True)
    _close(o, jo, 2e-5, 2e-5, "O vs JAX")
    _close(lse, res[-1], 2e-5, 2e-5, "lse vs JAX")

    grads = emulate_bwd(qt, kt, vt, o, lse, wt, plan, blk)
    plain = tfa.flash_attn_bwd_plain(qt, kt, vt, tk, tq, o, lse, wt)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_role_attention(q, k, v, jk, jq, True)
                       * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, p, j, name in zip(grads, plain, want, "qkv"):
        _close(g, p, 5e-4, 5e-5, f"d{name} vs plain")
        _close(g, j, 5e-4, 5e-5, f"d{name} vs JAX")


@pytest.mark.parametrize("n_ctx", [1, 31])
def test_emulated_walks_skip_most_pairs_at_an_eval_like_shape(n_ctx):
    """A pool of 300 points with scattered context and 20 selected
    targets: the walks visit a small share of the pairs and still give
    the plain forward and backward."""
    rng = np.random.default_rng(n_ctx)
    B, H, P, nt, dh = 2, 2, 300, 20, 8
    ctx = np.zeros((B, P), bool)
    for b in range(B):
        ctx[b, rng.choice(P, n_ctx, replace=False)] = True
    tmask = np.ones(nt, bool)
    tk, tq = _port_codes(ctx, tmask, False)
    N = P + nt
    q, k, v, w = (torch.from_numpy(rng.normal(size=(B, H, N, dh))
                                   .astype(np.float32)) for _ in range(4))
    plan = tfa.flash_plan(tk, tq)
    assert not plan.dense.any()
    walked = sum(int(_walks(plan, b)[1].sum()) for b in range(B))
    assert walked < 0.15 * B * N * N
    o, lse = emulate_fwd(q, k, v, plan, tfa.padded_len(N) - N, 128)
    po, plse = tfa.flash_attn_fwd_plain(q, k, v, tk, tq)
    _close(o, po, 2e-5, 2e-5, "O")
    _close(lse, plse, 2e-5, 2e-5, "lse")
    got = emulate_bwd(q, k, v, o, lse, w, plan, 128)
    want = tfa.flash_attn_bwd_plain(q, k, v, tk, tq, o, lse, w)
    for g, p, name in zip(got, want, "qkv"):
        _close(g, p, 5e-4, 5e-5, f"d{name}")


# -- the encoder builds one plan and passes it down --------------------------

class _EmulatedKernels(torch.autograd.Function):
    """The flash entry as the card runs it: both kernels walk ``plan``."""

    @staticmethod
    def forward(ctx, q, k, v, plan):
        N = q.shape[2]
        o, lse = emulate_fwd(q, k, v, plan, tfa.padded_len(N) - N, 128)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.plan = plan
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        return (*emulate_bwd(q, k, v, o, lse, g, ctx.plan, 128), None)


def test_encoder_builds_one_plan_and_matches_the_plain_path(monkeypatch):
    rng = np.random.default_rng(5)
    B, P, nt = 2, 14, 5
    ctx = rng.random((B, P)) < 0.4
    ctx[:, 0] = True
    tmask = rng.random(nt) < 0.5
    tmask[0] = True
    roles = troles.build_roles(torch.from_numpy(ctx), nt,
                               torch.from_numpy(tmask), True)
    cfg = EncoderConfig(dim_embedding=16, dim_feedforward=32, n_head=2,
                        num_layers=3, attention_impl="flash",
                        with_time_token=True)
    torch.manual_seed(0)
    enc = tenc.Encoder(cfg)
    tokens = torch.from_numpy(rng.normal(size=(B, P + nt, 16))
                              .astype(np.float32))
    t = torch.tensor(0.4)

    def run():
        enc.zero_grad()
        x = tokens.clone().requires_grad_()
        out = enc(x, roles, t)
        out.square().sum().backward()
        return out.detach(), x.grad, [p.grad.clone()
                                      for p in enc.parameters()]

    want = run()                     # the plain versions, no plan read

    plans, attention_plans = [], []

    def counting_plan(kcode, qrow):
        plans.append(tfa.flash_plan(kcode, qrow))
        return plans[-1]

    def card_attention(q, k, v, kcode, qrow, plan=None):
        attention_plans.append(plan)
        return _EmulatedKernels.apply(q, k, v, plan)

    monkeypatch.setattr(tenc, "flash_plan", counting_plan)
    monkeypatch.setattr(tenc, "flash_role_attention", card_attention)
    got = run()
    assert len(plans) == 1
    assert len(attention_plans) == cfg.num_layers
    assert all(p is plans[0] for p in attention_plans)
    _close(got[0], want[0], 2e-5, 2e-5, "encoded tokens")
    _close(got[1], want[1], 5e-4, 5e-5, "d tokens")
    for g, w_, (name, _) in zip(got[2], want[2], enc.named_parameters()):
        _close(g, w_, 5e-4, 5e-5, f"d {name}")
