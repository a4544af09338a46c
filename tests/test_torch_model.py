"""The port's roles, attention, embedder, encoder and full Aline forward
against the JAX package, from the same inputs and converted random-init
flax parameters at a small width (2 layers, d=16, H=2, F=32, C=4).

Tolerances: 1e-5 for the attention ops (float32 on both sides, JAX at
highest matmul precision), 1e-4 for the composed model, where the
summation orders of two frameworks' matmuls add up over the layers.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from aline_tpu import config as jcfg
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.models.encoder import EncoderLayer as JaxEncoderLayer
from aline_tpu.ops import attention as jatt
from aline_tpu.ops import roles as jroles
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.tasks.base import select_design as jax_select_design
from aline_tpu.tasks.gp import GPTask as JaxGPTask
from aline_tpu_torch.config import config_from_dict
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.ops import attention as tatt
from aline_tpu_torch.ops import roles as troles
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.utils.serialization import convert_flax_params

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# -- roles and attention ----------------------------------------------------

def _role_inputs(seed, B=3, P=9, n_target=5):
    rng = np.random.default_rng(seed)
    ctx = rng.random((B, P)) < 0.4
    ctx[:, 0] = True                         # every row has a context point
    tmask = rng.random(n_target) < 0.6
    tmask[0] = True
    return ctx, tmask


@pytest.mark.parametrize("seed", [0, 1])
def test_roles_and_bias_match_jax(seed):
    ctx, tmask = _role_inputs(seed)
    jr = jroles.build_roles(jnp.asarray(ctx), tmask.size, jnp.asarray(tmask))
    tr = troles.build_roles(_t(ctx), tmask.size, _t(tmask))
    assert not np.asarray(jr.k_is_time).any()    # no time token here
    for name in troles.Roles._fields:
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)
    _close(troles.attention_bias(tr), jroles.attention_bias(jr), 1e-5)
    j_idx, j_valid = jatt.context_indices(jnp.asarray(ctx), 6)
    t_idx, t_valid = tatt.context_indices(_t(ctx), 6)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))


@pytest.mark.parametrize("ext_idx", [None, (0, 2, 3)])
def test_attention_matches_jax(ext_idx):
    ctx, _ = _role_inputs(2)
    tmask = np.zeros(5, bool)
    tmask[list(ext_idx or range(5))] = True
    B, P = ctx.shape
    N, H, dh = P + tmask.size, 2, 8
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(B, H, N, dh)).astype(np.float32)
               for _ in range(3))
    jr = jroles.build_roles(jnp.asarray(ctx), tmask.size, jnp.asarray(tmask))
    tr = troles.build_roles(_t(ctx), tmask.size, _t(tmask))
    j_idx, j_valid = jatt.context_indices(jnp.asarray(ctx), 7)
    t_idx, t_valid = tatt.context_indices(_t(ctx), 7)
    want = jatt.compact_attention(
        *map(jnp.asarray, (q, k, v)), jr,
        jatt.CompactKeys(j_idx, j_valid, P, 0, ext_idx))
    got = tatt.compact_attention(
        *map(_t, (q, k, v)), tr,
        tatt.CompactKeys(t_idx, t_valid, P, ext_idx))
    _close(got, want, 1e-5)
    dense_j = jatt.dense_bias_attention(*map(jnp.asarray, (q, k, v)),
                                        jroles.attention_bias(jr))
    dense_t = tatt.dense_bias_attention(*map(_t, (q, k, v)),
                                        troles.attention_bias(tr))
    _close(dense_t, dense_j, 1e-5)
    _close(got, dense_t, 1e-5)      # compact is exact against the dense mask


# -- model ------------------------------------------------------------------

def _small_config():
    cfg = jcfg.Config(dtype="float32")
    cfg.task = jcfg.GPTaskConfig(
        name="AL_mix", dim_x=1, embedding_type="mix", n_context_init=1,
        n_query_init=12, n_target_data=6, n_target_theta=2)
    cfg.encoder = jcfg.EncoderConfig(dim_embedding=16, dim_feedforward=32,
                                     n_head=2, num_layers=2)
    cfg.head = jcfg.HeadConfig(num_components=4)
    return cfg


@pytest.fixture(scope="module")
def small():
    """JAX model, its random-init params, a mid-rollout JAX batch, and the
    port's model with the converted params."""
    cfg = _small_config()
    jmodel = jax_build_model(cfg)
    jbatch = JaxGPTask(cfg.task).sample_batch(jax.random.key(7), 3,
                                              n_query=12)
    jbatch = jax_init_ctx_idx(jbatch, 5)
    for step in ([4, 2, 9], [7, 11, 3]):
        jbatch = jax_select_design(jbatch, jnp.asarray(step))[0]
    params = jmodel.init(jax.random.key(0), jbatch, training=False)
    # perturb every leaf: flax initialises biases to 0 and LayerNorm
    # scales to 1, which would hide a misplaced bias or scale
    rng = np.random.default_rng(8)
    flat = {k: (np.asarray(v) + 0.1 * rng.normal(size=v.shape))
            .astype(np.float32)
            for k, v in flatten_dict(params, sep="/").items()}
    params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                            sep="/")
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    model = build_model(tcfg, "cpu")
    model.load_state_dict(convert_flax_params(flat, model))
    return jmodel, params, jbatch, model.eval(), flat


def test_embedder_matches_jax(small):
    jmodel, params, jbatch, model, _ = small
    want = jmodel.apply(params, jbatch,
                        method=lambda m, b: m.embedder(b))
    with torch.no_grad():
        got = model.embedder(batch_from_numpy(jbatch))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("tiny", [False, True])
def test_encoder_layer_matches_jax(small, tiny):
    """With ``tiny`` the inputs are scaled by 1e-3 and the attention
    biases zeroed, so the first LayerNorm sees a variance near 1e-6 and an
    epsilon other than flax's 1e-6 shows."""
    _, params, jbatch, model, _ = small
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, jbatch.n_points + jbatch.n_target, 16))
         * (1e-3 if tiny else 3.0)).astype(np.float32)
    jparams = unflatten_dict(flatten_dict(
        params["params"]["encoder"]["layer_0"]))            # a copy
    tlayer = copy.deepcopy(model.encoder.layer_0)
    if tiny:
        for name in ("qkv_proj", "out_proj"):
            bias = jparams["self_attn"][name]["bias"]
            jparams["self_attn"][name]["bias"] = jnp.zeros_like(bias)
            with torch.no_grad():
                getattr(tlayer.self_attn, name).bias.zero_()
    jr = jroles.build_roles(jbatch.ctx_mask, jbatch.n_target,
                            jbatch.target_mask)
    count = jnp.sum(jbatch.ctx_mask, axis=1)
    jplan = jatt.CompactKeys(
        jbatch.ctx_idx, jnp.arange(5)[None] < count[:, None],
        jbatch.n_points, 0, None)
    want = JaxEncoderLayer(16, 32, 2, 0.0, "auto").apply(
        {"params": jparams}, jnp.asarray(x), jr, None, jplan)
    tb = batch_from_numpy(jbatch)
    tr = troles.build_roles(tb.ctx_mask, tb.n_target, tb.target_mask)
    tplan = tatt.CompactKeys(tb.ctx_idx, _t(np.asarray(jplan.ctx_valid)),
                             tb.n_points)
    with torch.no_grad():
        got = tlayer(_t(x), tr, None, tplan)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("sel_targets", [None, (6, 7)])
def test_aline_forward_matches_jax(small, sel_targets):
    jmodel, params, jbatch, model, _ = small
    if sel_targets is not None:
        mask = np.zeros(jbatch.n_target, bool)
        mask[list(sel_targets)] = True
        jbatch = jbatch.replace(target_mask=jnp.asarray(mask))
    want = jmodel.apply(params, jbatch, training=False,
                        sel_targets=sel_targets)
    with torch.no_grad():
        got = model(batch_from_numpy(jbatch), sel_targets=sel_targets)
    np.testing.assert_array_equal(got.design_out.idx.numpy(),
                                  np.asarray(want.design_out.idx))
    _close(got.design_out.log_prob, want.design_out.log_prob, 1e-4)
    _close(got.design_out.zt, want.design_out.zt, 1e-4)
    for part in ("posterior_out", "posterior_out_query"):
        for name in ("mixture_means", "mixture_stds", "mixture_weights"):
            _close(getattr(getattr(got, part), name),
                   getattr(getattr(want, part), name), 1e-4)


def test_training_mode_samples_pool_points(small):
    """training=True draws the design from the pool-masked policy with the
    given generator (JAX's draws cannot be matched, so the draw is checked
    against the policy, which matches JAX in eval mode above)."""
    _, _, jbatch, model, _ = small
    batch = batch_from_numpy(jbatch)
    with torch.no_grad():
        runs = [model(batch, training=True,
                      generator=torch.Generator().manual_seed(3))
                for _ in range(2)]
    d = runs[0].design_out
    assert torch.equal(d.idx, runs[1].design_out.idx)
    assert batch.query_mask[torch.arange(batch.batch_size), d.idx].all()
    b = torch.arange(batch.batch_size)
    torch.testing.assert_close(d.log_prob.exp(), d.zt[b, d.idx])


def test_converter_rejects_missing_and_extra_keys(small):
    *_, model, flat = small
    missing = dict(flat)
    missing.pop("params/encoder/layer_1/norm2/scale")
    with pytest.raises(KeyError, match="norm2"):
        convert_flax_params(missing, model)
    extra = dict(flat)
    extra["params/head/value_head/predictor_fc1/kernel"] = np.zeros((16, 32))
    with pytest.raises(KeyError, match="value_head"):
        convert_flax_params(extra, model)
    bad = dict(flat)
    bad["params/head/target_head/heads_b2"] = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="heads_b2"):
        convert_flax_params(bad, model)
