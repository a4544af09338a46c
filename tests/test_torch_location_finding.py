"""The port's location-finding task (``aline_tpu_torch.tasks
.location_finding``) and its config against the JAX package's.

The physics (``total_density``, ``log_likelihood``) takes the same
numpy-drawn inputs on both sides, in the contrastive broadcast shapes of
the EIG fold, and agrees to rtol 1e-6, atol 1e-5 (float32 on both
sides; the same operations in the same order).  The priors and batches
draw from different generators, so they are held to their boxes,
moments and packing.  One training step on a location-finding batch is
held to JAX's at ``test_train_step_matches_jax``'s tolerance, 1e-4.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from aline_tpu import config as jcfg
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.ops import target_mask as jmask
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.tasks.location_finding import HiddenLocation as JaxLocation
from aline_tpu.train import loss as jloss
from aline_tpu.train import optimizer as jopt
from aline_tpu.train.rollout import rollout as jax_rollout
from aline_tpu.utils.serialization import load_config as jax_load_config
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.tasks.location_finding import HiddenLocation
from aline_tpu_torch.train import optimizer as topt
from aline_tpu_torch.train.loop import train_step
from aline_tpu_torch.train.rollout import rollout
from aline_tpu_torch.utils.serialization import convert_flax_params
from test_torch_train import _close, _jax_tree, _port_model, _shift_invariant

torch.set_num_threads(1)
LOC_RUN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints", "loc_100k")


def _task_cfgs(*extra):
    args = ["task=location_finding", *extra]
    return jcfg.parse_overrides(args).task, tcfg.parse_overrides(args).task


def _tasks(*extra):
    jc, tc = _task_cfgs(*extra)
    return JaxLocation(jc), HiddenLocation(tc)


@pytest.mark.parametrize("K", [1, 2])
def test_physics_matches_jax_in_contrastive_shapes(K):
    jt, tt = _tasks(f"task.K={K}", f"task.n_target_theta={2 * K}")
    rng = np.random.default_rng(K)
    Lc, B, Th, D = 7, 3, 5, 2
    f32 = np.float32
    y = rng.normal(size=(1, B, Th, 1)).astype(f32)
    xi = rng.uniform(size=(1, B, Th, D)).astype(f32)
    theta = rng.uniform(size=(Lc, B, 1, K, D)).astype(f32)
    theta[0, 0, 0, 0] = xi[0, 0, 0]          # a design on a source
    want_d = jt.total_density(jnp.asarray(xi), jnp.asarray(theta))
    got_d = tt.total_density(torch.from_numpy(xi), torch.from_numpy(theta))
    assert got_d.shape == (Lc, B, Th, 1)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6,
                               atol=1e-5)
    want = jt.log_likelihood(jnp.asarray(y), jnp.asarray(xi),
                             jnp.asarray(theta))
    got = tt.log_likelihood(torch.from_numpy(y), torch.from_numpy(xi),
                            torch.from_numpy(theta))
    assert got.shape == (Lc, B, Th, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("dist,low,high,mean,var", [
    ("uniform", 0.0, 1.0, 0.5, 1.0 / 12.0),
    ("normal", -4.0, 4.0, 0.0, 1.0)])
def test_priors_box_and_moments(dist, low, high, mean, var):
    jt, tt = _tasks(f"task.theta_dist={dist}")
    gen = torch.Generator().manual_seed(0)
    theta = tt.sample_theta(gen, (20_000,))
    want = np.asarray(jt.sample_theta(jax.random.key(0), (20_000,)))
    assert theta.shape == want.shape == (20_000, 1, 2)
    for th in (theta.numpy(), want):
        assert abs(th.mean() - mean) < 0.02
        assert abs(th.var() - var) < 0.03
    if dist == "uniform":
        assert 0.0 <= theta.min() and theta.max() < 1.0
    x = tt.sample_data(gen, 50, 400)
    assert x.shape == (50, 400, 2)
    assert low <= x.min() and x.max() <= high
    assert abs(x.mean().item() - (low + high) / 2) < 0.05 * (high - low)


@pytest.mark.parametrize("design_scale", [1.0, 2.5])
def test_sample_batch_shapes_and_packing(design_scale):
    _, tt = _tasks(f"task.design_scale={design_scale}")
    B, n_query = 64, 30
    batch = tt.sample_batch(torch.Generator().manual_seed(1), B, n_query)
    assert batch.x.shape == (B, 1 + n_query, 2)
    assert batch.y.shape == (B, 1 + n_query, 1)
    assert batch.theta.shape == (B, 1, 2)
    assert batch.target_x.shape == (B, 0, 2)
    assert batch.target_all.shape == (B, 2, 1)
    assert torch.equal(batch.target_all[..., 0], batch.theta[:, 0])
    assert batch.ctx_mask[:, 0].all() and not batch.ctx_mask[:, 1:].any()
    assert batch.target_mask.all() and batch.target_mask.shape == (2,)
    # x is normalised; y was simulated at the UNNORMALISED designs, so its
    # residual there is the observation noise
    assert 0.0 <= batch.x.min() and batch.x.max() <= 1.0
    signal = tt.total_density(tt.unnormalise_design(batch.x),
                              batch.theta[:, None])
    noise = batch.y - signal
    assert abs(noise.std().item() - tt.noise_scale) < 0.03
    assert abs(noise.mean().item()) < 0.03
    if design_scale != 1.0:
        wrong = batch.y - tt.total_density(batch.x, batch.theta[:, None])
        assert wrong.std().item() > 2 * tt.noise_scale


def test_design_space_helpers_match_jax():
    jt, tt = _tasks("task.design_scale=2.5")
    x = np.random.default_rng(2).uniform(size=(3, 4, 2)).astype(np.float32)
    for name in ("to_design_space", "normalise_design",
                 "unnormalise_design", "normalise_outcomes"):
        want = getattr(jt, name)(jnp.asarray(x))
        got = getattr(tt, name)(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)


def test_refusals():
    jc, tc = _task_cfgs("task.K=2")                 # n_target_theta stays 2
    with pytest.raises(ValueError, match="n_target_theta"):
        JaxLocation(jc)
    with pytest.raises(ValueError, match="n_target_theta"):
        HiddenLocation(tc)
    _, tc = _task_cfgs("task.theta_dist=gamma")
    with pytest.raises(ValueError, match="gamma"):
        HiddenLocation(tc)
    with pytest.raises(NotImplementedError, match="bogus"):
        build_task(tcfg.TaskConfig(target="bogus"))
    assert isinstance(build_task(tcfg.parse_overrides(
        ["task=location_finding"]).task), HiddenLocation)


def test_preset_and_run_config_read_like_jax():
    args = ["task=location_finding", "eval=bed", "eval.L=1000",
            "task.theta_dist=normal", "task.K=2", "task.n_target_theta=4",
            "dtype=bfloat16", "min_T=9"]
    assert tcfg.to_dict(tcfg.parse_overrides(args)) == \
        jcfg.to_dict(jcfg.parse_overrides(args))
    got = tcfg.load_config(LOC_RUN)
    assert isinstance(got.task, tcfg.LocationFindingConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jax_load_config(LOC_RUN))
    assert got.eval.EIG and got.task.K == 1 and got.dtype == "bfloat16"


SMALL_LOC = ["task=location_finding", "task.n_query_init=8",
             "encoder.dim_embedding=16", "encoder.dim_feedforward=32",
             "encoder.n_head=2", "encoder.num_layers=2",
             "head.num_components=4", "batch_size=4", "min_T=4", "T=4",
             "max_epoch=20", "burning_epoch=5", "checkpoint=0",
             "verbose=100"]


def test_loc_train_step_matches_jax():
    """One main-phase step (greedy rollout with equal indices, both
    losses, clip, AdamW) on a JAX-drawn location-finding batch, from the
    same perturbed random-init params, as ``test_train_step_matches_jax``
    takes it for the GP."""
    T = 4
    jc, tc = jcfg.parse_overrides(SMALL_LOC), tcfg.parse_overrides(SMALL_LOC)
    jbatch = JaxLocation(jc.task).sample_batch(jax.random.key(5), 4,
                                               n_query=8)
    jbatch = jax_init_ctx_idx(jbatch, 1 + T)
    mask = np.ones(jbatch.n_target, bool)
    w_q, w_p = jmask.target_weight_vectors(mask, "theta", "all", 0, 2)
    jmodel = jax_build_model(jc)
    params = jmodel.init(jax.random.key(0), jbatch, training=False)
    rng = np.random.default_rng(8)
    flat = {k: (np.asarray(v) + 0.1 * rng.normal(size=v.shape))
            .astype(np.float32)
            for k, v in flatten_dict(params, sep="/").items()}
    params = _jax_tree(flat)

    def loss_fn(p):
        ro = jax_rollout(jmodel, p, jbatch, T, jnp.asarray(w_q),
                         jnp.asarray(w_p), jax.random.key(0),
                         training=False)
        loss, m = jloss.total_loss(ro, jc.gamma, jnp.float32(jc.alpha))
        return loss, (m, ro.idx)

    (_, (jm, jidx)), jgrads = jax.value_and_grad(loss_fn,
                                                 has_aux=True)(params)
    tx, _ = jopt.build_optimizer(jc, params, "main")
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    model = _port_model(tc, flat)
    batch = batch_from_numpy(jbatch)
    with torch.no_grad():
        ro = rollout(model, batch, T, torch.from_numpy(w_q),
                     torch.from_numpy(w_p))
    np.testing.assert_array_equal(ro.idx.numpy(), np.asarray(jidx))
    opt, sched = topt.build_optimizer(tc, model, "main")
    m = train_step(model, opt, sched, batch, T, torch.from_numpy(w_q),
                   torch.from_numpy(w_p), tc.alpha, None, gamma=tc.gamma)
    for k in jm:
        _close(m[k], jm[k], 1e-4, k)
    flat_g = flatten_dict(jgrads, sep="/")
    scale = min(1.0, 1.0 / (max(float(jnp.max(jnp.abs(g)))
                                for g in flat_g.values()) + 1e-6))
    want_g = convert_flax_params(flat_g, model)
    for k, p in model.named_parameters():
        _close(p.grad, want_g[k] * scale, 1e-4, f"grad {k}")
    invariant = _shift_invariant(model)
    want_p = convert_flax_params(flatten_dict(jnew, sep="/"), model)
    for k, v in model.state_dict().items():
        keep = ~invariant[k] if k in invariant else slice(None)
        _close(v[keep], want_p[k][keep], 1e-4, f"param {k}")
