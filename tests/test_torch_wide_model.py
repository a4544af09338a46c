"""A wide ALINE through the port against the JAX package on the CPU.

The model of ``aline_tpu_torch/assets/al1d_wide128_config.json`` at small
depth: 1 layer, d=256, 2 heads of 128 (the wide config's head width),
F=1024 (F = 4 d), 10 components, ``attention_impl=flash``, float32, from
one JAX-initialised parameter set carried across by
``convert_flax_params``.  JAX runs its flash kernel in interpret mode; the
port runs the plain versions of its kernels (CPU tensors), the GMM head
through ``gmm_head`` (float32 ``auto``).

Tolerance 1e-4, as ``tests/test_torch_train.py`` holds the composed model
(two frameworks' matmuls sum in different orders over the layers, the
rollout and the backward pass); chosen indices exactly.
"""
import copy
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from aline_tpu import config as jcfg
from aline_tpu.eval.al_curves import al_rollout_curves as jax_curves
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.ops import target_mask as jmask
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.tasks.gp import GPTask as JaxGPTask
from aline_tpu.train import loss as jloss
from aline_tpu.train import optimizer as jopt
from aline_tpu.train.rollout import rollout as jax_rollout
from aline_tpu_torch.config import (WIDE128_RECIPE, config_from_dict,
                                    parse_overrides, to_dict)
from aline_tpu_torch.eval.al_curves import al_rollout_curves
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.ops import _build
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.train import optimizer as topt
from aline_tpu_torch.train.loop import train_step
from aline_tpu_torch.train.rollout import rollout
from aline_tpu_torch.utils.serialization import convert_flax_params
from test_torch_train import _shift_invariant

torch.set_num_threads(1)
TOL = 1e-4
ASSET = os.path.join(os.path.dirname(__file__), "..", "aline_tpu_torch",
                     "assets", "al1d_wide128_config.json")


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=msg)


def test_wide_recipe_resolves_to_the_committed_config():
    with open(ASSET) as f:
        want = json.load(f)
    assert "dim_feedforward" in want.pop("assumed")
    got = to_dict(parse_overrides(list(WIDE128_RECIPE)
                                  + ["output_dir=outputs/al1d_wide128"]))
    assert got == want
    enc = want["encoder"]
    assert (enc["dim_embedding"], enc["n_head"], enc["dim_feedforward"],
            enc["num_layers"], enc["attention_impl"]) == (1024, 8, 4096, 3,
                                                          "flash")
    assert enc["dim_embedding"] // enc["n_head"] == 128
    assert want["head"]["num_components"] == 10


def _config():
    cfg = jcfg.Config(dtype="float32")
    cfg.task = jcfg.GPTaskConfig(
        name="AL_mix", dim_x=1, embedding_type="mix", n_context_init=1,
        n_query_init=12, n_target_data=6, n_target_theta=2)
    cfg.encoder = jcfg.EncoderConfig(dim_embedding=256, dim_feedforward=1024,
                                     n_head=2, num_layers=1,
                                     attention_impl="flash")
    cfg.head = jcfg.HeadConfig(num_components=10)
    return cfg


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX init's parameters (flattened numpy) and a JAX batch."""
    cfg = _config()
    jbatch = JaxGPTask(cfg.task).sample_batch(jax.random.key(3), 3,
                                              n_query=12)
    jbatch = jax_init_ctx_idx(jbatch, 5)
    params = jax_build_model(copy.deepcopy(cfg)).init(
        jax.random.key(0), jbatch, training=False)
    return ({k: np.asarray(v) for k, v in
             flatten_dict(params, sep="/").items()}, jbatch)


def _models(cfg):
    flat, _ = _params()
    jparams = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                             sep="/")
    model = build_model(config_from_dict(dataclasses.asdict(cfg)), "cpu")
    model.load_state_dict(convert_flax_params(flat, model))
    assert model.head.target_head.use_kernel(20)       # the gmm_head path
    return jax_build_model(copy.deepcopy(cfg)), jparams, model.eval()


def test_wide_al_rollout_matches_jax():
    _, jbatch = _params()
    jmodel, params, model = _models(_config())
    assert model.head.target_head.heads_w1.shape == (10, 256, 1024)
    T = 4
    want = jax_curves(jmodel, params, jbatch, T, jax.random.key(1))
    before = dict(_build.LAUNCHES)
    got = al_rollout_curves(model, batch_from_numpy(jbatch), T)
    assert _build.LAUNCHES == before        # CPU tensors launch no kernel
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    for key in ("log_prob", "rmse"):
        _close(got[key], want[key], key)


def test_wide_train_step_matches_jax():
    """One greedy step (rollout → loss → grads → clip → AdamW, main
    phase), as tests/test_torch_train.py holds the flagship's, from the
    same params on a JAX-drawn batch with the data mask."""
    T = 3
    jc = _config()
    jc.max_epoch, jc.burning_epoch = 20, 5
    jbatch = JaxGPTask(jc.task).sample_batch(jax.random.key(5), 3,
                                             n_query=8)
    mask = np.zeros(jbatch.n_target, bool)
    mask[:6] = True                                   # the data targets
    jbatch = jax_init_ctx_idx(jbatch.replace(target_mask=jnp.asarray(mask)),
                              1 + T)
    w_q, w_p = jmask.target_weight_vectors(mask, "mix", "split", 6, 2)
    jmodel, params, model = _models(jc)
    model.train()

    def loss_fn(p):
        ro = jax_rollout(jmodel, p, jbatch, T, jnp.asarray(w_q),
                         jnp.asarray(w_p), jax.random.key(0),
                         training=False)
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
        ro = rollout(model, batch, T, w_q, w_p)
    np.testing.assert_array_equal(ro.idx.numpy(), np.asarray(jidx))
    opt, sched = topt.build_optimizer(tc, model, "main")
    m = train_step(model, opt, sched, batch, T, w_q, w_p, tc.alpha, None,
                   gamma=tc.gamma)
    for k in jm:
        _close(m[k], jm[k], k)
    _close(m["grad_norm"], optax.global_norm(jgrads))
    flat_g = flatten_dict(jgrads, sep="/")
    scale = min(1.0, 1.0 / (max(float(jnp.max(jnp.abs(g)))
                                for g in flat_g.values()) + 1e-6))
    want_g = convert_flax_params(flat_g, model)
    for k, p in model.named_parameters():             # the clipped grads
        _close(p.grad, want_g[k] * scale, f"grad {k}")
    # the update: Adam's first step divides each gradient element by its
    # own size, so an element whose two gradients differ by more than 1%
    # of it (rounding noise, e.g. the entries that shift every logit of a
    # softmax alike) moves by an ill-determined amount up to lr either
    # way: resolved elements within TOL, every element within 2·lr (as
    # chip_smoke.py's train_step_parity holds the card to the CPU)
    invariant = _shift_invariant(model)
    want_p = convert_flax_params(flatten_dict(jnew, sep="/"), model)
    resolved_n = 0
    for k, v in model.state_dict().items():
        g, want = model.get_parameter(k).grad, want_g[k] * scale
        if k in invariant:
            assert g[invariant[k]].abs().max() < 1e-6, k
        resolved = want.abs() >= 100 * (g - want).abs()
        if k in invariant:
            resolved &= ~invariant[k]
        resolved_n += int(resolved.sum())
        _close(v[resolved], want_p[k][resolved], f"param {k}")
        assert (v - want_p[k]).abs().max() <= 2 * tc.lr + TOL, k
    assert resolved_n > 0.99 * sum(p.numel() for p in model.parameters())
