"""The port's continuous-design path (the continuous embedder and
Gaussian-policy head, ``train/continuous.py``, ``train_continuous.py``)
and the value and single heads, against the JAX package on the CPU.

From the same flax parameters (converted) and JAX's draws on its key
schedule (``split(k, 3)`` per step: the carry, the policy noise, the
simulator noise): greedy and sampled rollouts agree to 1e-5; one training
step of each objective (REINFORCE; pathwise sPCE with ``alpha=0
alpha_pce=1``) to 1e-4 in the loss and 1e-4 of each gradient element
plus 1e-4 of the largest; the value and single heads' forwards to 1e-5.
A fresh model's new parameters follow flax's initialisers.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from aline_tpu import config as jcfg
from aline_tpu.eval.eig_losses import pce_loss as j_pce_loss
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.tasks import build_task as jax_build_task
from aline_tpu.train import loss as jloss
from aline_tpu.train.continuous import make_continuous_batch as j_make
from aline_tpu.train.continuous import rollout_continuous as j_rollout
from aline_tpu.train.rollout import RolloutOutputs as JRollout
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.train.continuous import rollout_continuous
from aline_tpu_torch.train_continuous import (
    DEFAULTS,
    ContinuousTrainer,
    continuous_loss,
    main as train_continuous_main,
)
from aline_tpu_torch.utils.serialization import (
    convert_flax_params,
    export_flax_params,
)

torch.set_num_threads(1)

SMALL = ["encoder.dim_embedding=16", "encoder.dim_feedforward=32",
         "encoder.n_head=2", "encoder.num_layers=2",
         "head.num_components=4", "batch_size=4", "min_T=3", "T=3",
         "pce_L=7"]
B, T = 4, 3


def _cfgs(*extra):
    args = DEFAULTS + SMALL + list(extra)
    return jcfg.parse_overrides(args), tcfg.parse_overrides(args)


def _flat(params, seed=1):
    """flax params, perturbed so that no bias is zero."""
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.05 * rng.normal(size=v.shape))
            .astype(np.float32)
            for k, v in flatten_dict(params, sep="/").items()}


def _setup(*extra):
    jc, tc = _cfgs(*extra)
    jt, tt = jax_build_task(jc.task), build_task(tc.task)
    jm = jax_build_model(jc)
    jb = j_make(jt, jax.random.key(1), B, T)
    flat = _flat(jm.init(jax.random.key(0), jb, training=False))
    model = build_model(tc, "cpu")
    model.load_state_dict(convert_flax_params(flat, model))
    return jc, tc, jt, tt, jm, jb, flat, model


def _jax_noise(key, n_x=2):
    dn, sn = [], []
    k = key
    for _ in range(T):
        k, kd, ks = jax.random.split(k, 3)
        dn.append(np.asarray(jax.random.normal(kd, (B, 1, n_x))))
        sn.append(np.asarray(jax.random.normal(ks, (B, 1))))
    return torch.from_numpy(np.stack(dn)), torch.from_numpy(np.stack(sn))


def _tree(flat):
    from flax.traverse_util import unflatten_dict
    return unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                          sep="/")


@pytest.mark.parametrize("training", [False, True])
def test_rollout_matches_jax(training):
    jc, tc, jt, tt, jm, jb, flat, model = _setup("time_token=true")
    w = jnp.full((2,), 0.5)
    key = jax.random.key(2)
    want = j_rollout(jm, _tree(flat), jt, jb, T, w, w, key,
                     training=training, time_token=True, use_remat=False)
    dn, sn = _jax_noise(key)
    wt = torch.full((2,), 0.5)
    with torch.no_grad():
        got = rollout_continuous(model, tt, batch_from_numpy(jb), T, wt, wt,
                                 sn, dn, training=training, time_token=True,
                                 use_remat=False)
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _grads_close(got, want):
    scale = want.abs().max()
    assert ((got - want).abs() <= 1e-4 * want.abs() + 1e-4 * scale).all()


@pytest.mark.parametrize("objective", ["reinforce", "pathwise"])
def test_training_step_matches_jax(objective):
    extra = ["alpha=0", "alpha_pce=1"] if objective == "pathwise" else []
    jc, tc, jt, tt, jm, jb, flat, model = _setup(*extra)
    k_roll, k_contr = jax.random.key(3), jax.random.key(4)
    n_t = jt.n_target_theta
    w = jnp.full((n_t,), 1.0 / n_t, jnp.float32)
    contr = jt.sample_theta(k_contr, (jc.pce_L, B))

    def loss_fn(p):       # scripts/train_continuous.py's, main phase
        ro = j_rollout(jm, p, jt, jb, T, w, w, k_roll, training=True,
                       use_remat=True)
        loss, m = jloss.total_loss(
            JRollout(ro.log_probs, ro.nll_query, ro.nll_pred, None, ro.xs,
                     ro.ys, None), jc.gamma, jnp.float32(jc.alpha))
        if jc.alpha_pce > 0:
            xs = jt.to_design_space(jnp.swapaxes(ro.xs, 0, 1))
            thetas = jnp.concatenate([jb.theta[None], contr], axis=0)
            l_pce = j_pce_loss(jt, jnp.swapaxes(ro.ys, 0, 1), xs, thetas)
            loss = loss + 1.0 * jc.alpha_pce * l_pce
        return loss

    want, jgrads = jax.value_and_grad(loss_fn)(_tree(flat))
    dn, sn = _jax_noise(k_roll)
    loss, m = continuous_loss(
        model, tt, tc, batch_from_numpy(jb), dn, sn,
        torch.from_numpy(np.array(contr)), alpha=tc.alpha, design_on=1.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4,
                               atol=1e-4)
    if objective == "pathwise":
        assert math.isclose(m["spce_train"].item(),
                            math.log(8.0) - m["pce_loss"].item(),
                            rel_tol=1e-6)
    want_g = convert_flax_params(flatten_dict(jgrads, sep="/"), model)
    for name, p in model.named_parameters():
        _grads_close(p.grad, want_g[name])


def test_value_and_single_heads_match_jax():
    args = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
            "task.n_query_init=8", "task.n_target_data=4",
            "encoder.dim_embedding=16", "encoder.dim_feedforward=32",
            "encoder.n_head=2", "encoder.num_layers=2",
            "head.num_components=4", "head.value_head=true",
            "head.single_head=true"]
    jc, tc = jcfg.parse_overrides(args), tcfg.parse_overrides(args)
    jt = jax_build_task(jc.task)
    jb = jt.sample_batch(jax.random.key(5), 3, n_query=8)
    ctx = np.zeros((3, 9), bool)
    ctx[0, :4] = True
    ctx[1, :1] = True                      # row 2 has no context point
    jb = jb.replace(ctx_mask=jnp.asarray(ctx))
    jm = jax_build_model(jc)
    flat = _flat(jm.init(jax.random.key(6), jb, training=False), 7)
    want = jm.apply(_tree(flat), jb, training=False)
    model = build_model(tc, "cpu")
    model.load_state_dict(convert_flax_params(flat, model))
    with torch.no_grad():
        got = model(batch_from_numpy(jb))
    pairs = [("value", got.value, want.value)]
    for po in ("posterior_out", "posterior_out_query"):
        for f in ("mixture_means", "mixture_stds", "mixture_weights"):
            pairs.append((f"{po}.{f}", getattr(getattr(got, po), f),
                          getattr(getattr(want, po), f)))
    for name, g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert got.value[2] == model.head.value_head.empty_value[0]


def test_fresh_new_parameters_follow_flax_init():
    """The continuous head and embedder (flagship widths), the value and
    single heads: each new parameter's mean and std against a flax init
    within 5 standard errors; biases and ``empty_value`` zero."""
    for args in (DEFAULTS, ["task=al_mix", "task.dim_x=1",
                            "task.n_target_theta=2", "head.value_head=true",
                            "head.single_head=true"]):
        jc, tc = jcfg.parse_overrides(args), tcfg.parse_overrides(args)
        jt = jax_build_task(jc.task)
        jb = (j_make(jt, jax.random.key(1), 2, 3) if jc.head.continuous
              else jt.sample_batch(jax.random.key(1), 2, n_query=4))
        flax_flat = {k: np.asarray(v) for k, v in flatten_dict(
            jax_build_model(jc).init(jax.random.key(2), jb,
                                     training=False), sep="/").items()}
        torch.manual_seed(3)
        port = export_flax_params(build_model(tc, "cpu"))
        assert set(port) == set(flax_flat)
        new = [k for k in port if any(s in k for s in (
            "query_token", "mean_predictor", "log_std_predictor",
            "value_head", "target_head/fc"))]
        assert new
        for k in new:
            got, want = port[k], flax_flat[k]
            assert got.shape == want.shape, k
            if k.endswith(("bias", "empty_value")):
                assert not got.any() and not want.any(), k
                continue
            n, sd = got.size, want.std()
            assert abs(got.mean() - want.mean()) < 5 * sd * math.sqrt(
                2 / n), k
            assert abs(got.std() - sd) < 5 * sd * math.sqrt(1 / n), k


def test_cli_trains_resumes_and_bounds(tmp_path):
    common = SMALL + ["device=cpu", "burning_epoch=2", "verbose=2",
                      "eval.EIG=true", "eval.M_final=6",
                      "eval.batch_size_final=4", "eval.T_final=3",
                      "eval.L_final=200", "alpha_pce=1"]
    a = tmp_path / "a"
    run = train_continuous_main(common + ["max_epoch=4", "checkpoint=2",
                                          f"output_dir={a}"])
    assert len(run["epoch_s"]) == 4
    b = run["bounds"]
    assert np.isfinite(b["pce_mean"]) and b["nmc_mean"] >= \
        b["pce_mean"] - 1e-5
    with np.load(a / "continuous_bounds.npz") as saved:
        assert int(saved["M"]) == 6 and int(saved["L"]) == 200
    # 2 epochs, a checkpoint, and a run resumed from it: the same final
    # parameters
    bdir = tmp_path / "b"
    _, first = _cfgs("burning_epoch=2", "max_epoch=4", "alpha_pce=1",
                     f"output_dir={bdir}")
    b = ContinuousTrainer(first, device="cpu")
    for epoch in range(2):
        b.train_epoch(epoch)
    b.save(2)
    train_continuous_main(common + ["max_epoch=4", "checkpoint=0",
                                    "eval.EIG=false", "load_checkpoint=true",
                                    f"output_dir={bdir}"])
    with np.load(a / "model" / "aline_cont.npz") as x, \
            np.load(bdir / "model" / "aline_cont.npz") as y:
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    # load_path warm-starts the parameters only
    c = train_continuous_main(common + [
        "max_epoch=0", "eval.EIG=false", f"output_dir={tmp_path / 'c'}",
        f"load_path={a / 'model' / 'aline_cont.npz'}"])
    got = export_flax_params(c["trainer"].model)
    with np.load(a / "model" / "aline_cont.npz") as x:
        for k in x.files:
            np.testing.assert_array_equal(got[k], x[k], err_msg=k)
