"""The global time token (``encoder.with_time_token``), the design head's
time feature (``time_token``) and ``attention_impl=flash`` through the
port's model, AL curves and training step, against the JAX package at a
small width (2 layers, d=16, H=2, F=32, C=4) with converted, perturbed
random-init parameters.  JAX runs its flash kernel in interpret mode.

Tolerance 1e-4 wherever the composed model is compared (two frameworks'
matmuls sum in different orders over the layers, the rollout and the
backward pass); chosen indices exactly.
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from aline_tpu import config as jcfg
from aline_tpu.eval.al_curves import al_rollout_curves as jax_curves
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.ops import target_mask as jmask
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.tasks.base import select_design as jax_select_design
from aline_tpu.tasks.gp import GPTask as JaxGPTask
from aline_tpu.train import loss as jloss
from aline_tpu.train import optimizer as jopt
from aline_tpu.train.rollout import rollout as jax_rollout
from aline_tpu_torch.config import config_from_dict
from aline_tpu_torch.eval.al_curves import al_rollout_curves
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.train import optimizer as topt
from aline_tpu_torch.train.loop import train_step
from aline_tpu_torch.train.rollout import rollout
from aline_tpu_torch.utils.serialization import convert_flax_params
from test_torch_train import _shift_invariant

torch.set_num_threads(1)
TOL = 1e-4

# (encoder.with_time_token, time_token)
VARIANTS = [(True, False), (False, True), (True, True)]


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=msg)


def _config(with_time, time_token, impl="auto", **task):
    cfg = jcfg.Config(dtype="float32", time_token=time_token)
    cfg.task = jcfg.GPTaskConfig(
        name="AL_mix", dim_x=1, embedding_type="mix", n_context_init=1,
        n_query_init=12, n_target_data=6, n_target_theta=2, **task)
    cfg.encoder = jcfg.EncoderConfig(dim_embedding=16, dim_feedforward=32,
                                     n_head=2, num_layers=2,
                                     with_time_token=with_time,
                                     attention_impl=impl)
    cfg.head = jcfg.HeadConfig(num_components=4)
    return cfg


@functools.lru_cache(maxsize=None)
def _variant(with_time, time_token):
    """JAX params of the variant (every leaf perturbed, so that no bias is
    0 and no scale 1) and a mid-rollout JAX batch with t = 0.4."""
    cfg = _config(with_time, time_token)
    jbatch = JaxGPTask(cfg.task).sample_batch(jax.random.key(7), 3,
                                              n_query=12)
    jbatch = jax_init_ctx_idx(jbatch, 5)
    for step in ([4, 2, 9], [7, 11, 3]):
        jbatch = jax_select_design(jbatch, jnp.asarray(step))[0]
    jbatch = jbatch.replace(t=jnp.asarray(0.4, jnp.float32))
    params = jax_build_model(cfg).init(jax.random.key(0), jbatch,
                                       training=False)
    rng = np.random.default_rng(8)
    flat = {k: (np.asarray(v) + 0.1 * rng.normal(size=v.shape))
            .astype(np.float32)
            for k, v in flatten_dict(params, sep="/").items()}
    return flat, jbatch


def _models(cfg, flat):
    jparams = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                             sep="/")
    model = build_model(config_from_dict(dataclasses.asdict(cfg)), "cpu")
    model.load_state_dict(convert_flax_params(flat, model))
    return jax_build_model(cfg), jparams, model.eval()


@pytest.mark.parametrize("impl", ["compact", "flash", "naive"])
@pytest.mark.parametrize("with_time,time_token", VARIANTS)
def test_forward_matches_jax(with_time, time_token, impl):
    flat, jbatch = _variant(with_time, time_token)
    if with_time:
        assert "params/encoder/time_proj/kernel" in flat
    jmodel, params, model = _models(_config(with_time, time_token, impl),
                                    flat)
    want = jmodel.apply(params, jbatch, training=False)
    with torch.no_grad():
        got = model(batch_from_numpy(jbatch))
    np.testing.assert_array_equal(got.design_out.idx.numpy(),
                                  np.asarray(want.design_out.idx))
    _close(got.design_out.log_prob, want.design_out.log_prob)
    _close(got.design_out.zt, want.design_out.zt)
    for part in ("posterior_out", "posterior_out_query"):
        for name in ("mixture_means", "mixture_stds", "mixture_weights"):
            _close(getattr(getattr(got, part), name),
                   getattr(getattr(want, part), name), f"{part}.{name}")


class _TimeSpy(torch.nn.Module):
    """Records the time scalar of every forward."""

    def __init__(self, model):
        super().__init__()
        self.model, self.seen = model, []

    def forward(self, batch, **kw):
        self.seen.append(float(batch.t))
        return self.model(batch, **kw)


def test_time_runs_forward_in_training_and_backward_in_eval():
    """t/T at rollout step t in training, (T - t)/T in the AL curves,
    whose final forward keeps the last step's time."""
    flat, jbatch = _variant(True, True)
    *_, model = _models(_config(True, True), flat)
    T = 4
    batch = batch_from_numpy(jbatch)
    spy = _TimeSpy(model)
    w = torch.full((batch.n_target,), 1.0 / batch.n_target)
    with torch.no_grad():
        rollout(spy, batch, T, w, w, time_token=True, use_remat=False)
    assert spy.seen == [t / T for t in range(T)]
    spy.seen.clear()
    al_rollout_curves(spy, batch, T, time_token=True)
    assert spy.seen == [(T - t) / T for t in range(T)] + [1 / T]
    spy.seen.clear()
    with torch.no_grad():
        rollout(spy, batch, T, w, w, use_remat=False)
    assert spy.seen == [0.0] * T       # no time feature: 0, as in JAX


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_al_curves_with_time_token_match_jax(impl):
    flat, jbatch = _variant(True, True)
    jmodel, params, model = _models(_config(True, True, impl), flat)
    T = 4
    want = jax_curves(jmodel, params, jbatch, T, jax.random.key(1),
                      time_token=True)
    got = al_rollout_curves(model, batch_from_numpy(jbatch), T,
                            time_token=True)
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    for key in ("log_prob", "rmse"):
        _close(got[key], want[key], key)


def test_flash_time_token_train_step_matches_jax():
    """One greedy step with ``attention_impl=flash`` and both time options
    (rollout → loss → grads → clip → AdamW, main phase), as
    ``tests/test_torch_train.py::test_train_step_matches_jax`` holds the
    default path, from the same params on a JAX-drawn batch with a fixed
    split mask."""
    T = 4
    jc = _config(True, True, "flash")
    jc.max_epoch, jc.burning_epoch = 20, 5
    flat, _ = _variant(True, True)
    jbatch = JaxGPTask(jc.task).sample_batch(jax.random.key(5), 4,
                                             n_query=8)
    mask = np.zeros(jbatch.n_target, bool)
    mask[:6] = True                                   # the data targets
    jbatch = jax_init_ctx_idx(jbatch.replace(target_mask=jnp.asarray(mask)),
                              1 + T)
    w_q, w_p = jmask.target_weight_vectors(mask, "mix", "split", 6, 2)
    jmodel, params, model = _models(jc, flat)
    model.train()

    def loss_fn(p):
        ro = jax_rollout(jmodel, p, jbatch, T, jnp.asarray(w_q),
                         jnp.asarray(w_p), jax.random.key(0),
                         training=False, time_token=True)
        loss, m = jloss.total_loss(ro, jc.gamma, jnp.float32(jc.alpha))
        return loss, (m, ro.idx)

    (_, (jm, jidx)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    tx, _ = jopt.build_optimizer(jc, params, "main")
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    tc = config_from_dict(dataclasses.asdict(copy.deepcopy(jc)))
    batch = batch_from_numpy(jbatch)
    w_q, w_p = torch.from_numpy(w_q), torch.from_numpy(w_p)
    with torch.no_grad():
        ro = rollout(model, batch, T, w_q, w_p, time_token=True)
    np.testing.assert_array_equal(ro.idx.numpy(), np.asarray(jidx))
    opt, sched = topt.build_optimizer(tc, model, "main")
    m = train_step(model, opt, sched, batch, T, w_q, w_p, tc.alpha, None,
                   gamma=tc.gamma, time_token=True)
    for k in jm:
        _close(m[k], jm[k], k)
    _close(m["grad_norm"], optax.global_norm(jgrads))
    flat_g = flatten_dict(jgrads, sep="/")
    scale = min(1.0, 1.0 / (max(float(jnp.max(jnp.abs(g)))
                                for g in flat_g.values()) + 1e-6))
    want_g = convert_flax_params(flat_g, model)
    for k, p in model.named_parameters():             # the clipped grads
        _close(p.grad, want_g[k] * scale, f"grad {k}")
    # entries that shift every logit of a softmax alike: zero gradient
    # (see test_torch_train.py).  The time feature, like the bias, is the
    # same for every candidate, so its weight into a hidden unit of the
    # design head that is active on every pool point (or on none) is such
    # an entry too.
    invariant = _shift_invariant(model)
    fc1 = "head.acquisition_head.predictor_fc1."
    invariant[fc1 + "bias"] = want_g[fc1 + "bias"].abs() < 1e-6
    invariant[fc1 + "weight"] = torch.zeros_like(want_g[fc1 + "weight"],
                                                 dtype=torch.bool)
    invariant[fc1 + "weight"][:, -1] = \
        want_g[fc1 + "weight"][:, -1].abs() < 1e-6
    want_p = convert_flax_params(flatten_dict(jnew, sep="/"), model)
    for k, v in model.state_dict().items():
        keep = slice(None)
        if k in invariant:
            keep = ~invariant[k]
            assert model.get_parameter(k).grad[invariant[k]].abs().max() \
                < 1e-6, k
        _close(v[keep], want_p[k][keep], f"param {k}")
