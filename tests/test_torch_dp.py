"""The port's data-parallel trainer (``aline_tpu_torch/train/loop.py`` on a
``mesh_data`` axis) at ``tests/test_data_parallel.py``'s recipe, with JAX's
initial parameters carried across by ``convert_flax_params``; the ranks
are 2 gloo processes (``tests/torch_ranks.py``).

* One main-phase step on 2 ranks (B=16, mask ``split``, the same batch,
  greedy designs): the all-reduced, clipped gradients equal JAX's
  single-device step within 1e-4 (``tests/test_torch_train.py``'s bar for
  one step) and the port's one-process step within 1e-5; with the same
  Gumbel noise, too, the one-process step.
* The reward is normalised over the GLOBAL batch: normalising each rank's
  rows alone is another function, and its gradients leave JAX's by far
  more than the tolerance (checked below).
* The parameters are bitwise equal across the ranks after 3 epochs and at
  the end; the losses of the first 4 epochs are within 1e-5 of the
  one-process run (JAX's own test notes that parameters after Adam are not
  comparable at near-zero REINFORCE gradients).
* ``batch_size=6`` with ``mesh_data=4`` warns and trains every row on
  every rank, as ``test_indivisible_batch_falls_back``.
* A checkpoint written at 2 ranks resumes in 1 process: its epochs 4 and
  5 give the 2-rank run's losses within 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from aline_tpu import config as jcfg
from aline_tpu.ops import target_mask as jmask
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.train import loss as jloss
from aline_tpu.train.loop import Trainer as JaxTrainer
from aline_tpu.train.rollout import rollout as jax_rollout
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.models.heads import gumbel_noise
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.train.loop import Trainer, train_step
from aline_tpu_torch.train.optimizer import build_optimizer
from aline_tpu_torch.utils.serialization import convert_flax_params
from torch_ranks import (dp_step_worker, dp_train_worker, numpy_batch,
                         run_ranks)

torch.set_num_threads(1)
WORLD = 2
T = 3
DP = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
      "task.n_context_init=1", "task.n_query_init=8", "task.n_target_data=4",
      "batch_size=16", "min_T=3", "T=3", "max_epoch=6", "burning_epoch=2",
      "checkpoint=4", "verbose=100"]
ODD = DP[:6] + ["batch_size=6", "min_T=3", "T=3", "max_epoch=1",
                "burning_epoch=1", "checkpoint=0", "verbose=100",
                "mesh_data=4"]
TOL_JAX, TOL_PORT = 1e-4, 1e-5


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """JAX's parameters and batch, the JAX step's gradients, and the
    2-rank steps, greedy and with Gumbel noise."""
    tmp = tmp_path_factory.mktemp("dp_step")
    jc = jcfg.parse_overrides(DP + ["mesh_data=1", f"output_dir={tmp}"])
    jt = JaxTrainer(jc)
    flat = {k: np.asarray(v) for k, v in
            flatten_dict(jt.params, sep="/").items()}
    jbatch = jt._sample_batch(jax.random.key(7), 16, 8)
    mask = jmask.create_target_mask("split", "mix", 4, 2, attend_to="data")
    w_q, w_p = jmask.target_weight_vectors(mask, "mix", "split", 4, 2)
    jbatch = jax_init_ctx_idx(jbatch.replace(target_mask=jnp.asarray(mask)),
                              1 + T)
    sel = tuple(int(i) for i in np.flatnonzero(mask))

    def loss_fn(p):
        ro = jax_rollout(jt.model, p, jbatch, T, jnp.asarray(w_q),
                         jnp.asarray(w_p), jax.random.key(0),
                         training=False, sel_targets=sel)
        return jloss.total_loss(ro, jc.gamma, jnp.float32(jc.alpha))

    (_, jm), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jt.params)
    batch_np = numpy_batch(jbatch)
    noise = gumbel_noise((T, 16, jbatch.n_points),
                         torch.Generator().manual_seed(3)).numpy()
    overrides = DP + ["mesh_data=2"]
    ranks = {kind: run_ranks(dp_step_worker, WORLD, tmp, overrides, flat,
                             batch_np, w_q, w_p, T, nz)
             for kind, nz in (("greedy", None), ("gumbel", noise))}
    return dict(flat=flat, batch_np=batch_np, w_q=w_q, w_p=w_p, sel=sel,
                noise=noise, jm=jm, jgrads=flatten_dict(jgrads, sep="/"),
                ranks=ranks)


def _port_step(s, rows=slice(None), noise=None, clip=True):
    """The port's one-process step on ``rows`` of the batch: (metrics,
    grads)."""
    tc = tcfg.parse_overrides(DP)
    model = build_model(tc, "cpu")
    model.load_state_dict(convert_flax_params(s["flat"], model))
    b = batch_from_numpy(s["batch_np"])
    b = b.replace(**{f: getattr(b, f)[rows] for f in
                     ("x", "y", "ctx_mask", "target_x", "target_all",
                      "theta", "ctx_idx")})
    opt, sched = build_optimizer(tc, model, "main")
    nz = None if noise is None else torch.from_numpy(noise[:, rows].copy())
    m = train_step(model, opt, sched, b, T, torch.from_numpy(s["w_q"]),
                   torch.from_numpy(s["w_p"]), tc.alpha, nz, gamma=tc.gamma,
                   clip_grads=clip, sel_targets=s["sel"])
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.numpy().copy() for n, p in model.named_parameters()})


def _jax_grads(s, model_like, clip=True):
    g = s["jgrads"]
    scale = 1.0
    if clip:
        scale = min(1.0, 1.0 / (max(float(np.abs(v).max())
                                    for v in g.values()) + 1e-6))
    return {k: v.numpy() * scale
            for k, v in convert_flax_params(g, model_like).items()}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


def test_dp_step_gradients_match_jax(step):
    model = build_model(tcfg.parse_overrides(DP), "cpu")
    want = _jax_grads(step, model)
    for r, (m, grads, _) in enumerate(step["ranks"]["greedy"]):
        for k in ("loss", "design_loss", "predict_loss"):
            _close(m[k], float(step["jm"][k]), TOL_JAX, f"{k} rank {r}")
        for n, g in grads.items():
            _close(g, want[n], TOL_JAX, f"grad {n} rank {r}")


@pytest.mark.parametrize("kind", ["greedy", "gumbel"])
def test_dp_step_equals_one_process_step(step, kind):
    noise = step["noise"] if kind == "gumbel" else None
    m1, g1 = _port_step(step, noise=noise)
    (m0, g0, p0), (mr, gr, pr) = step["ranks"][kind]
    for k in m1:
        _close(m0[k], m1[k], TOL_PORT, k)
        assert m0[k] == mr[k], k
    for n in g1:
        _close(g0[n], g1[n], TOL_PORT, f"grad {n}")
        np.testing.assert_array_equal(g0[n], gr[n], err_msg=n)
        np.testing.assert_array_equal(p0[n], pr[n], err_msg=n)


def test_per_rank_reward_normalisation_would_fail(step):
    """Each half of the batch normalised on its own, the gradients
    averaged: another function.  Its unclipped gradients leave JAX's by
    1.8e-2 at this recipe (the largest entry's gap, read on the CPU),
    180 times the 1e-4 bar that the global normalisation meets."""
    model = build_model(tcfg.parse_overrides(DP), "cpu")
    want = _jax_grads(step, model, clip=False)
    halves = [_port_step(step, slice(i * 8, (i + 1) * 8), clip=False)[1]
              for i in range(2)]
    worst = max(float(np.abs((halves[0][n] + halves[1][n]) / 2
                             - want[n]).max()) for n in want)
    assert worst > 10 * TOL_JAX, worst
    _, whole = _port_step(step, clip=False)
    assert max(float(np.abs(whole[n] - want[n]).max())
               for n in want) < TOL_JAX


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_train")
    out = tmp / "run"
    ranks = run_ranks(dp_train_worker, WORLD, tmp, DP + ["mesh_data=2"],
                      str(out), ODD)
    return dict(out=out, ranks=ranks)


def test_params_bitwise_equal_across_ranks(trained):
    r0, r1 = trained["ranks"]
    assert r0["n_data"] == r1["n_data"] == 2
    for key in ("after3", "final"):
        for n in r0[key]:
            np.testing.assert_array_equal(r0[key][n], r1[key][n],
                                          err_msg=f"{key} {n}")
    assert r0["losses"] == r1["losses"]


def test_dp_losses_match_one_process(trained, tmp_path):
    tc = tcfg.parse_overrides(DP + [f"output_dir={tmp_path}"])
    tr = Trainer(tc, device="cpu")
    tr._ensure_phase("burning")
    losses = [float(tr.train_epoch(e)["loss"]) for e in range(4)]
    _close(trained["ranks"][0]["losses"][:4], losses, TOL_PORT)


def test_indivisible_batch_trains_every_row_on_every_rank(trained):
    for r in trained["ranks"]:
        odd = r["odd"]
        assert odd["n_data"] == 1
        assert np.isfinite(odd["loss"])
        assert any("not divisible by 4" in line for line in odd["log"])
    assert trained["ranks"][0]["odd"]["loss"] == \
        trained["ranks"][1]["odd"]["loss"]


def test_checkpoint_of_two_ranks_resumes_in_one_process(trained):
    out = trained["out"]
    assert (out / "ckpt.pt").exists()
    tc = tcfg.parse_overrides(DP + [f"output_dir={out}"])
    tr = Trainer(tc, device="cpu")
    tr.restore()
    assert tr.start_epoch == 4 and tr.n_data == 1
    losses = [float(tr.train_epoch(e)["loss"]) for e in (4, 5)]
    _close(losses, trained["ranks"][0]["losses"][4:], TOL_PORT)
