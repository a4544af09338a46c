"""bfloat16 compute in the port against the JAX package's bfloat16, module by
module, at the flagship's widths (D=32, F=128, H=4, C=10) with its trained
parameters (the committed npz) or, for the time token and the time
feature, which the flagship does not have, a seeded init at its widths.

What "bfloat16" means on both sides: float32 parameters cast at each use;
a Dense sums its product in float32, rounds it to bfloat16 and adds the
bias in bfloat16 (a second rounding); a LayerNorm normalises in float32
and rounds once; the attention scores are rounded to bfloat16 by their
einsum before the float32 softmax (compact and dense paths) or kept in
float32 (flash); the GMM head's einsum path rounds at each einsum.

JAX runs op by op (eager flax ``apply``, the Pallas kernel in interpret
mode), so every rounding the modules declare happens.

Tolerances: every bfloat16 output is compared as bits.  ``assert_ulps``
allows ``share`` of the elements to lie 1 bfloat16 ulp apart and none
further.  The share is 0 (bitwise) for the dense layer, the LayerNorm,
the embedder, the attention ops, the compact and dense encoder layers and
the time token.  Where the flash attention's float32 sums run in another
order than the Pallas kernel's, a sum can land on the other side of a
rounding boundary: the flash encoder layer and O allow 0.1% of the
elements 1 ulp apart, the flash VJP 0.5% (its dQ at dh=32 had 0.18%).
Float32 outputs computed from bitwise-equal bfloat16 values (the design
scores, the GMM mixture) agree to rtol = atol = 1e-5 (compact), and the
whole model through flash, where a 1-ulp difference in O travels through
the layers, to 1e-3 (design probabilities) and 2e-2 (mixture means, stds
and weights: one bfloat16 ulp of a value up to 4).  The GMM head's
kernel path is float32 on both sides: 1e-5.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from aline_tpu.models import encoder as jenc
from aline_tpu.models import heads as jheads
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.ops import attention as jatt
from aline_tpu.ops import flash_attention as jfa
from aline_tpu.ops import roles as jroles
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.tasks.base import select_design as jax_select_design
from aline_tpu.tasks.gp import GPTask as JaxGPTask
from aline_tpu.utils.serialization import load_config as jax_load_config
from aline_tpu_torch.config import config_from_dict
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.models.dense import Dense
from aline_tpu_torch.models.heads import FUSED_MIN_TOKENS, GMMTargetHead
from aline_tpu_torch.ops import _build
from aline_tpu_torch.ops import attention as tatt
from aline_tpu_torch.ops import flash_attention as tfa
from aline_tpu_torch.ops import roles as troles
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.utils.serialization import (
    AL1D_200K_PARAMS,
    convert_flax_params,
    load_model,
)
from test_torch_al_curves import RUN_DIR, f32_run_copy

torch.set_num_threads(1)
BF16 = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x):
    """bfloat16 values (torch or JAX) as their int32 order keys."""
    if isinstance(x, torch.Tensor):
        u = x.to(BF16).view(torch.int16).numpy().astype(np.int32)
    else:
        u = np.asarray(x).astype(jnp.bfloat16).view(np.int16).astype(
            np.int32)
    # sign-magnitude to a monotone integer order
    return np.where(u < 0, -(u & 0x7FFF), u)


def assert_ulps(got, want, share=0.0, msg="", floor=0.0):
    """got (torch) and want (JAX) bfloat16 with at most ``share`` of the
    elements 1 ulp apart and none further; with ``floor``, elements within
    ``floor`` times want's largest magnitude of each other count as 1 ulp
    apart (near 0 a float32 difference in the last bits of a cancelling
    sum is many bfloat16 ulps)."""
    assert tuple(got.shape) == tuple(np.shape(want)), msg
    d = np.abs(_bits(got) - _bits(want))
    w = np.asarray(want).astype(np.float32)
    small = np.abs(got.float().numpy() - w) <= floor * np.abs(w).max(
        initial=0)
    d = np.where(small & (d > 1), 1, d)
    assert d.max(initial=0) <= 1, f"{msg}: {d.max()} ulps apart"
    assert (d > 0).mean() <= share, \
        f"{msg}: {(d > 0).mean():.2%} of the elements 1 ulp apart"


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(
        want, np.float32), rtol=tol, atol=tol, err_msg=msg)


def _flat_params():
    with np.load(AL1D_200K_PARAMS) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def flagship():
    """The flagship's JAX model (bfloat16, from its config.json), its
    params, the port's model as ``load_model`` builds it (the run's own
    dtype), and a JAX batch 4 steps into a rollout."""
    cfg = jax_load_config(RUN_DIR)
    assert cfg.dtype == "bfloat16"
    jmodel = jax_build_model(cfg)
    flat = _flat_params()
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                            sep="/")
    jbatch = JaxGPTask(cfg.task).sample_batch(jax.random.key(3), 3,
                                              n_query=40)
    jbatch = jax_init_ctx_idx(jbatch, 6)
    for step in ([4, 12, 9], [7, 30, 3], [20, 5, 33]):
        jbatch = jax_select_design(jbatch, jnp.asarray(step))[0]
    _, model = load_model(RUN_DIR, AL1D_200K_PARAMS, "cpu")
    return jmodel, params, flat, model, jbatch


def test_load_model_follows_the_runs_dtype(flagship, tmp_path):
    *_, model, _ = flagship
    assert model.encoder.layer_0.linear1.compute_dtype == BF16
    assert model.head.target_head.dtype == BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _, f32 = load_model(f32_run_copy(tmp_path), AL1D_200K_PARAMS, "cpu")
    assert f32.encoder.layer_0.linear1.compute_dtype == torch.float32
    for (n, a), b in zip(model.state_dict().items(),
                         f32.state_dict().values()):
        assert torch.equal(a, b), n


# -- the dense layer and the LayerNorm --------------------------------------

@pytest.mark.parametrize("layer", ["linear1", "linear2"])
def test_dense_matches_flax_bitwise(flagship, layer):
    _, _, flat, _, _ = flagship
    pre = f"params/encoder/layer_0/{layer}/"
    kernel, bias = flat[pre + "kernel"], flat[pre + "bias"]
    x = np.random.default_rng(0).normal(size=(3, 143, kernel.shape[0])) \
        .astype(np.float32)
    want = fnn.Dense(kernel.shape[1], dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    dense = Dense(*kernel.shape, dtype=BF16)
    with torch.no_grad():
        dense.weight.copy_(_t(kernel.T))
        dense.bias.copy_(_t(bias))
        got = dense(_t(x))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_ulps(got, want, 0.0, layer)
    # bfloat16 input: the same
    xb = _t(x).to(BF16)
    with torch.no_grad():
        got = dense(xb)
    want = fnn.Dense(kernel.shape[1], dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kernel, "bias": bias}},
        jnp.asarray(x).astype(jnp.bfloat16))
    assert_ulps(got, want, 0.0, layer + " bf16 input")


def test_dense_in_float32_is_linear():
    dense = Dense(8, 5)
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(dense(x), torch.nn.functional.linear(
        x, dense.weight, dense.bias))


@pytest.mark.parametrize("norm", ["norm1", "norm2"])
def test_layer_norm_matches_flax_bitwise(flagship, norm):
    _, _, flat, model, _ = flagship
    pre = f"params/encoder/layer_1/{norm}/"
    x = (np.random.default_rng(1).normal(size=(3, 143, 32)) * 2.0 + 0.3) \
        .astype(jnp.bfloat16)
    want = fnn.LayerNorm(dtype=jnp.bfloat16).apply(
        {"params": {"scale": flat[pre + "scale"], "bias": flat[pre + "bias"]}},
        jnp.asarray(x))
    layer = model.encoder.layer_1
    with torch.no_grad():
        got = layer._norm(getattr(layer, norm),
                          _t(x.astype(np.float32)).to(BF16))
    assert_ulps(got, want, 0.0, norm)


# -- embedder, attention, encoder layers ------------------------------------

def test_embedder_matches_jax_bitwise(flagship):
    jmodel, params, _, model, jbatch = flagship
    want = jmodel.apply(params, jbatch, method=lambda m, b: m.embedder(b))
    with torch.no_grad():
        got = model.embedder(batch_from_numpy(jbatch))
    assert got.dtype == BF16
    assert_ulps(got, want, 0.0, "tokens")


def _qkv(B, H, N, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, N, dh)).astype(jnp.bfloat16)
            for _ in range(3)]


def _roles(jbatch, with_time=False):
    jr = jroles.build_roles(jbatch.ctx_mask, jbatch.n_target,
                            jbatch.target_mask, with_time)
    tb = batch_from_numpy(jbatch)
    tr = troles.build_roles(tb.ctx_mask, tb.n_target, tb.target_mask,
                            with_time)
    return jr, tr, tb


def test_compact_and_dense_attention_match_jax_bitwise(flagship):
    *_, jbatch = flagship
    jr, tr, tb = _roles(jbatch)
    N = jbatch.n_points + jbatch.n_target
    q, k, v = _qkv(3, 4, N, 8, 2)
    count = jnp.sum(jbatch.ctx_mask, axis=1)
    valid = jnp.arange(6)[None] < count[:, None]
    want = jatt.compact_attention(
        *map(jnp.asarray, (q, k, v)), jr,
        jatt.CompactKeys(jbatch.ctx_idx, valid, jbatch.n_points, 0, None))
    tq, tk, tv = (_t(a.astype(np.float32)).to(BF16) for a in (q, k, v))
    got = tatt.compact_attention(
        tq, tk, tv, tr, tatt.CompactKeys(tb.ctx_idx, _t(valid),
                                         tb.n_points))
    assert got.dtype == BF16
    assert_ulps(got, want, 0.0, "compact")
    want = jatt.dense_bias_attention(
        *map(jnp.asarray, (q, k, v)),
        jroles.attention_bias(jr, jnp.bfloat16))
    got = tatt.dense_bias_attention(tq, tk, tv,
                                    troles.attention_bias(tr, BF16))
    assert_ulps(got, want, 0.0, "dense")


@pytest.mark.parametrize("impl", ["compact", "naive", "flash"])
def test_encoder_layer_matches_jax(flagship, impl):
    _, params, _, model, jbatch = flagship
    jr, tr, tb = _roles(jbatch)
    N = jbatch.n_points + jbatch.n_target
    x = (np.random.default_rng(4).normal(size=(3, N, 32)) * 2.0) \
        .astype(jnp.bfloat16)
    bias = compact = None
    tbias = tcompact = codes = None
    if impl == "compact":
        count = jnp.sum(jbatch.ctx_mask, axis=1)
        valid = jnp.arange(6)[None] < count[:, None]
        compact = jatt.CompactKeys(jbatch.ctx_idx, valid, jbatch.n_points,
                                   0, None)
        tcompact = tatt.CompactKeys(tb.ctx_idx, _t(valid), tb.n_points)
    elif impl == "naive":
        bias = jroles.attention_bias(jr, jnp.bfloat16)
        tbias = troles.attention_bias(tr, BF16)
    else:
        kcode, qrow = troles.roles_to_codes(tr)
        codes = (kcode, qrow, tfa.flash_plan(kcode, qrow))
    want = jenc.EncoderLayer(32, 128, 4, 0.0, impl, jnp.bfloat16).apply(
        {"params": params["params"]["encoder"]["layer_0"]}, jnp.asarray(x),
        jr, bias, compact)
    with torch.no_grad():
        got = model.encoder.layer_0(_t(x.astype(np.float32)).to(BF16), tr,
                                    tbias, tcompact, codes)
    assert got.dtype == BF16
    assert_ulps(got, want, 0.001 if impl == "flash" else 0.0, impl)


# -- the time token and the time feature (seeded init, flagship widths) -----

@pytest.fixture(scope="module")
def timed():
    """The flagship's config with the time token and the time feature, a
    seeded init at its widths with every leaf perturbed, and the port's
    model with the same params, both computing in bfloat16."""
    cfg = jax_load_config(RUN_DIR)
    cfg.time_token = True
    cfg.encoder.with_time_token = True
    jbatch = JaxGPTask(cfg.task).sample_batch(jax.random.key(4), 3,
                                              n_query=24)
    jbatch = jax_init_ctx_idx(jbatch, 5)
    for step in ([4, 12, 9], [7, 20, 3]):
        jbatch = jax_select_design(jbatch, jnp.asarray(step))[0]
    jbatch = jbatch.replace(t=jnp.asarray(29 / 30, jnp.float32))
    params = jax_build_model(cfg).init(jax.random.key(0), jbatch,
                                       training=False)
    rng = np.random.default_rng(8)
    flat = {k: (np.asarray(v) + 0.1 * rng.normal(size=v.shape))
            .astype(np.float32)
            for k, v in flatten_dict(params, sep="/").items()}
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                            sep="/")
    model = build_model(config_from_dict(dataclasses.asdict(cfg)), "cpu")
    model.load_state_dict(convert_flax_params(flat, model))
    return cfg, params, flat, model.eval(), jbatch


def test_time_token_matches_jax_bitwise(timed):
    _, _, flat, model, jbatch = timed
    pre = "params/encoder/time_proj/"
    t = jnp.asarray(29 / 30, jnp.float32)
    tokens = jnp.zeros((1, 1, 32), jnp.bfloat16)
    want = fnn.Dense(32, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": flat[pre + "kernel"],
                    "bias": flat[pre + "bias"]}},
        jnp.reshape(t, (1, 1)).astype(tokens.dtype))
    with torch.no_grad():
        got = model.encoder.time_proj(
            torch.tensor(29 / 30).reshape(1, 1).to(BF16))
    assert_ulps(got, want, 0.0, "time_proj")


@pytest.mark.parametrize("impl", ["compact", "flash"])
def test_encoder_with_time_token_matches_jax(timed, impl):
    cfg, params, _, model, jbatch = timed
    cfg = copy.deepcopy(cfg)
    cfg.encoder.attention_impl = impl
    jm = jax_build_model(cfg)
    model.encoder.impl = impl
    try:
        want = jm.apply(params, jbatch, training=False)
        with torch.no_grad():
            got = model(batch_from_numpy(jbatch))
    finally:
        model.encoder.impl = "auto"
    np.testing.assert_array_equal(got.design_out.idx.numpy(),
                                  np.asarray(want.design_out.idx))
    flash = impl == "flash"
    _close(got.design_out.zt, want.design_out.zt, 1e-3 if flash else 1e-5,
           "zt")
    for part in ("posterior_out", "posterior_out_query"):
        for name in ("mixture_means", "mixture_stds", "mixture_weights"):
            _close(getattr(getattr(got, part), name),
                   getattr(getattr(want, part), name),
                   2e-2 if flash else 1e-5, f"{part}.{name}")


def test_acquisition_head_with_time_feature_matches_jax(timed):
    _, params, _, model, _ = timed
    z = (np.random.default_rng(6).normal(size=(3, 41, 32))).astype(
        jnp.bfloat16)
    t = jnp.asarray(29 / 30, jnp.float32)
    want = jheads.AcquisitionHead(128, True, jnp.bfloat16).apply(
        {"params": params["params"]["head"]["acquisition_head"]},
        jnp.asarray(z), t)
    head = model.head.acquisition_head
    with torch.no_grad():
        got = head(_t(z.astype(np.float32)).to(BF16),
                   torch.tensor(29 / 30))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    # float32 scores of a bfloat16 Dense: bitwise equal as float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the GMM head ------------------------------------------------------------

def _gmm(flat, fused, T, seed=7, dtype=BF16):
    pre = "params/head/target_head/"
    w = {n: flat[pre + n] for n in ("heads_w1", "heads_b1", "heads_w2",
                                    "heads_b2")}
    z = np.random.default_rng(seed).normal(size=(2, T, 32)).astype(
        jnp.bfloat16)
    head = GMMTargetHead(32, 128, 10, 1e-4, dtype=dtype, fused=fused)
    head.load_state_dict({k: _t(v) for k, v in w.items()})
    return w, z, head


@pytest.mark.parametrize("fused", ["off", "auto"])
def test_gmm_einsum_path_matches_flax(flagship, fused):
    """Below FUSED_MIN_TOKENS ``auto`` takes the einsum path in bfloat16,
    as ``off`` does at any count: flax's ``fused=False`` head."""
    _, _, flat, _, _ = flagship
    w, z, head = _gmm(flat, fused, 102)
    assert not head.use_kernel(102)
    want = jheads.GMMTargetHead(1, 32, 128, 10, dtype=jnp.bfloat16,
                                fused=False).apply({"params": w},
                                                   jnp.asarray(z))
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        got = head(_t(z.astype(np.float32)).to(BF16))
    assert _build.LAUNCHES == before
    for name in ("mixture_means", "mixture_stds", "mixture_weights"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("fused,T", [("auto", FUSED_MIN_TOKENS),
                                     ("on", 102)])
def test_gmm_kernel_path_matches_the_pallas_head(flagship, fused, T):
    """From FUSED_MIN_TOKENS on (``auto``), or always (``on``), the head
    runs the float32 kernel on z widened: JAX's ``fused_gmm_head`` on
    ``z.astype(float32)`` in interpret mode, to 1e-5."""
    from aline_tpu.ops.gmm_head_kernel import fused_gmm_head
    _, _, flat, _, _ = flagship
    w, z, head = _gmm(flat, fused, T)
    assert head.use_kernel(T)
    out = fused_gmm_head(jnp.asarray(z).astype(jnp.float32),
                         w["heads_w1"], w["heads_b1"], w["heads_w2"],
                         w["heads_b2"], True)
    with torch.no_grad():
        got = head(_t(z.astype(np.float32)).to(BF16))
    np.testing.assert_allclose(got.mixture_means.numpy(),
                               np.asarray(out[..., 0]), rtol=1e-5, atol=1e-5)
    std = jax.nn.softplus(out[..., 1]) + 1e-4
    np.testing.assert_allclose(got.mixture_stds.numpy(), np.asarray(std),
                               rtol=1e-5, atol=1e-5)


def test_gmm_rule_by_dtype_and_count():
    for dtype, fused, T, want in (
            (torch.float32, "auto", 7, True),
            (torch.float32, "auto", 5000, True),
            (BF16, "auto", FUSED_MIN_TOKENS - 1, False),
            (BF16, "auto", FUSED_MIN_TOKENS, True),
            (BF16, "on", 7, True), (torch.float32, "off", 5000, False),
            (BF16, "off", 5000, False)):
        head = GMMTargetHead(8, 16, 2, dtype=dtype, fused=fused)
        assert head.use_kernel(T) == want, (dtype, fused, T)
    with pytest.raises(ValueError, match="fused_gmm"):
        GMMTargetHead(8, 16, 2, fused="yes")


# -- flash attention: the plain versions against the Pallas kernel ---------

# (B, H, n_points, n_target, dh, with_time, blind): the shapes of
# tests/test_torch_flash_attention.py and a multi-block N > 128
FLASH_CASES = {
    "dh8 time": (2, 2, 12, 5, 8, True, False),
    "N37 ragged time": (1, 2, 30, 6, 16, True, False),
    "fully masked time": (2, 2, 9, 3, 8, True, True),
    "N303 three blocks": (2, 2, 201, 102, 8, False, False),
    "N300 blind dh32": (2, 2, 290, 9, 32, True, True),
}


def _flash_inputs(case, seed=0):
    B, H, P, nt, dh, with_time, blind = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    ctx = rng.random((B, P)) < min(0.4, 16 / P)
    ctx[:, 0] = True
    tmask = rng.random(nt) < 0.5
    tmask[0] = True
    if blind:
        ctx[1] = False
        tmask[:] = False
    N = int(with_time) + P + nt
    q, k, v, w = (rng.normal(size=(B, H, N, dh)).astype(jnp.bfloat16)
                  for _ in range(4))
    jr = jroles.build_roles(jnp.asarray(ctx), nt, jnp.asarray(tmask),
                            with_time)
    tr = troles.build_roles(_t(ctx), nt, _t(tmask), with_time)
    return jfa.roles_to_codes(jr), troles.roles_to_codes(tr), q, k, v, w


def _bt(a):
    return _t(np.asarray(a).astype(np.float32)).to(BF16)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_matches_the_pallas_kernel_in_bf16(case):
    """O (bfloat16) to 1 ulp in at most 0.1% of the elements, lse
    (float32) to 2e-5: the scores are float32 sums of exact products on
    both sides, in another order."""
    (jk, jq), (tk, tq), q, k, v, _ = _flash_inputs(case)
    want = jfa.flash_role_attention(*map(jnp.asarray, (q, k, v)), jk, jq,
                                    True)
    o, lse = tfa.flash_attn_fwd(*map(_bt, (q, k, v)), tk, tq)
    assert o.dtype == BF16 and lse.dtype == torch.float32
    assert_ulps(o, want, 0.001, "O")
    _, res = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), jk, jq, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[-1]), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_vjp_matches_the_pallas_kernel_in_bf16(case):
    """dQ, dK and dV (bfloat16, dK and dV summed into bfloat16 block by
    block of ``block_q(N)`` rows on both sides) from the same O and lse:
    1 ulp in at most 0.5% of the elements, or within 1e-5 of the
    gradient's largest element."""
    (jk, jq), (tk, tq), q, k, v, w = _flash_inputs(case, seed=1)
    args = tuple(map(jnp.asarray, (q, k, v)))
    o, vjp = jax.vjp(lambda a, b, c: jfa.flash_role_attention(
        a, b, c, jk, jq, True), *args)
    want = vjp(jnp.asarray(w))
    _, res = jfa._flash_fwd(*args, jk, jq, True)
    got = tfa.flash_attn_bwd(*map(_bt, (q, k, v)), tk, tq, _bt(o),
                             _t(np.asarray(res[-1])), _bt(w))
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == BF16
        assert_ulps(g, r, 0.005, name, floor=1e-5)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_bwd_summed_once(case):
    """dK and dV summed over all rows in float32 and rounded once (the CUDA
    kernels' sums, ``per_block=False``) against the TPU kernel's per-block
    bfloat16 sums: bitwise equal with one block of rows, and with more
    within 2^-7 of each element plus (n_blocks + 1) * 2^-8 of the largest,
    the tolerance the card holds the kernels to."""
    (_, _), (tk, tq), q, k, v, w = _flash_inputs(case, seed=2)
    args = (*map(_bt, (q, k, v)), tk, tq)
    o, lse = tfa.flash_attn_fwd(*args)
    blocks = tfa.flash_attn_bwd_plain(*args, o, lse, _bt(w))
    once = tfa.flash_attn_bwd_plain(*args, o, lse, _bt(w), per_block=False)
    assert torch.equal(blocks[0], once[0])                  # dQ alike
    N = q.shape[2]
    n_blocks = -(-N // tfa.block_q(N))
    for name, a, b in zip(("dk", "dv"), once[1:], blocks[1:]):
        assert a.dtype == BF16, name
        if n_blocks == 1:
            assert torch.equal(a, b), name
        a, b = a.float(), b.float()
        bound = (2.0 ** -7 * b.abs()
                 + (n_blocks + 1) * 2.0 ** -8 * b.abs().max())
        assert bool(((a - b).abs() <= bound).all()), name


def test_flash_wrappers_take_bf16_and_refuse_mixed_types():
    (_, _), (tk, tq), q, k, v, w = _flash_inputs("dh8 time")
    bq, bk, bv = map(_bt, (q, k, v))
    o, lse = tfa.flash_attn_fwd(bq, bk, bv, tk, tq)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attn_fwd(bq.half(), bk.half(), bv.half(), tk, tq)
    with pytest.raises(TypeError):
        tfa.flash_attn_fwd(bq, bk.float(), bv, tk, tq)
    with pytest.raises(TypeError):
        tfa.flash_attn_bwd(bq, bk, bv, tk, tq, o, lse.to(BF16), _bt(w))
    with pytest.raises(TypeError):
        tfa.flash_attn_bwd(bq, bk, bv, tk, tq, o.float(), lse, _bt(w))
    before = dict(_build.LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (bq, bk, bv)]
    out = tfa.flash_role_attention(*leaves, tk, tq)
    out.backward(_bt(w))
    assert out.dtype == BF16
    assert all(t.grad.dtype == BF16 for t in leaves)
    assert _build.LAUNCHES == before     # CPU tensors launch no kernel
