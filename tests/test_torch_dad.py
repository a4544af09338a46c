"""The port's DAD baseline (``aline_tpu_torch.models.baselines``
``SetEquivariantDesignNetwork``, ``run_trace``; ``train_dad.py``) against
``aline_tpu/models/baselines.py`` and ``scripts/train_dad.py`` on the CPU.

From the same flax parameters (converted) and JAX's draws on its key
schedule (``split(key)`` for theta and the trace, then ``split(k, 3)``
per step: the carry, the simulator noise, the exploration noise): the
trace agrees to 1e-5, one pathwise sPCE step's gradients to 1e-4 of each
element plus 1e-4 of the largest; the learning rate equals
``optax.cosine_decay_schedule`` at steps 0, S/2 and S.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from aline_tpu import config as jcfg
from aline_tpu.eval.eig_losses import pce_loss as j_pce_loss
from aline_tpu.models.baselines import SetEquivariantDesignNetwork as JaxDAD
from aline_tpu.models.baselines import run_trace as j_run_trace
from aline_tpu.tasks import build_task as jax_build_task
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.models.baselines import (
    SetEquivariantDesignNetwork,
    run_trace,
)
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.train_dad import DEFAULTS, DADTrainer, dad_loss
from aline_tpu_torch.train_dad import main as train_dad_main
from aline_tpu_torch.utils.serialization import (
    convert_flax_params,
    export_flax_params,
)

torch.set_num_threads(1)
T, M, H, E = 4, 5, 16, 8


def _setup():
    jc, tc = jcfg.parse_overrides(DEFAULTS), tcfg.parse_overrides(DEFAULTS)
    jt, tt = jax_build_task(jc.task), build_task(tc.task)
    jm = JaxDAD(dim_x=2, dim_y=1, hidden_dim=H, encoding_dim=E)
    params = jm.init(jax.random.key(0), jnp.zeros((2, T, 2)),
                     jnp.zeros((2, T, 1)), jnp.zeros((2, T), bool))
    rng = np.random.default_rng(1)
    flat = {k: (np.asarray(v) + 0.1 * rng.normal(size=v.shape))
            .astype(np.float32)
            for k, v in flatten_dict(params, sep="/").items()}
    model = SetEquivariantDesignNetwork(2, 1, H, E)
    model.load_state_dict(convert_flax_params(flat, model))
    tree = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                          sep="/")
    return jt, tt, jm, tree, flat, model


def _jax_draws(jt, key):
    """theta and the per-step noises ``run_trace`` draws from ``key``."""
    k_theta, k = jax.random.split(key)
    theta = jt.sample_theta(k_theta, (M,))
    sim, explore = [], []
    for _ in range(T):
        k, k_sim, k_exp = jax.random.split(k, 3)
        sim.append(np.asarray(jax.random.normal(k_sim, (M, 1))))
        explore.append(np.asarray(jax.random.normal(k_exp, (M, 2))))
    return (torch.from_numpy(np.array(theta)),
            torch.from_numpy(np.stack(sim)),
            torch.from_numpy(np.stack(explore)))


@pytest.mark.parametrize("explore_std", [0.0, 0.3])
def test_run_trace_matches_jax(explore_std):
    jt, tt, jm, tree, flat, model = _setup()
    key = jax.random.key(2)
    want = j_run_trace(jm, tree, jt, T, M, key, explore_std=explore_std)
    with torch.no_grad():
        got = run_trace(model, tt, *_jax_draws(jt, key), explore_std)
    for name, g, w in zip(("theta", "xs", "ys"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # the converter's round trip of the DAD tree
    out = export_flax_params(model)
    assert set(out) == set(flat)
    for k, v in out.items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_pathwise_step_gradients_match_jax():
    jt, tt, jm, tree, flat, model = _setup()
    key, k_contr = jax.random.key(3), jax.random.key(4)
    L = 9
    contr = jt.sample_theta(k_contr, (L, M))

    def loss_fn(p):                  # scripts/train_dad.py's
        theta0, xs, ys = j_run_trace(jm, p, jt, T, M, key, explore_std=0.2)
        return j_pce_loss(jt, ys, xs, jnp.concatenate([theta0[None], contr]))

    want, jgrads = jax.value_and_grad(loss_fn)(tree)
    loss = dad_loss(model, tt, *_jax_draws(jt, key),
                    torch.from_numpy(np.array(contr)), 0.2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4,
                               atol=1e-4)
    want_g = convert_flax_params(flatten_dict(jgrads, sep="/"), model)
    for name, p in model.named_parameters():
        if p.grad is None:                   # empty_value: unused
            assert not want_g[name].any(), name
            continue
        w = want_g[name]
        assert ((p.grad - w).abs() <= 1e-4 * w.abs()
                + 1e-4 * w.abs().max()).all(), name


def test_learning_rate_is_optax_cosine_decay():
    S = 8
    cfg = tcfg.parse_overrides(DEFAULTS + [f"max_epoch={S}"])
    trainer = DADTrainer(cfg, device="cpu")
    sched = optax.cosine_decay_schedule(cfg.lr, S)
    lrs = {}
    for step in range(S + 1):
        lrs[step] = trainer.optimizer.param_groups[0]["lr"]
        trainer.optimizer.step()
        trainer.scheduler.step()
    for step in (0, S // 2, S):
        np.testing.assert_allclose(lrs[step], float(sched(step)), rtol=1e-6,
                                   atol=1e-12)


def test_cli_trains_and_bounds(tmp_path):
    out = tmp_path / "dad"
    run = train_dad_main([
        "device=cpu", "T=3", "batch_size=8", "max_epoch=3", "verbose=1",
        "checkpoint=2", "eval.L=15", "eval.L_final=300", "eval.M_final=6",
        "eval.batch_size_final=4", "eval.T_final=3", "explore_std=0.1",
        f"output_dir={out}"])
    b = run["bounds"]
    assert np.isfinite(b["pce_mean"]) and b["nmc_mean"] >= \
        b["pce_mean"] - 1e-5
    assert (out / "ckpt_dad.pt").exists() and (out / "dad_bounds.npz").exists()
    with np.load(out / "model" / "dad.npz") as saved:
        assert "params/encoder/linear1/kernel" in saved.files
