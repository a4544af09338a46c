"""The trainer's last settings in the port: ``remat_policy=dots``,
``debug_nans``, ``profile_dir``, the phase timer and metric store
(``aline_tpu_torch/utils/metrics.py``), against the JAX package where it
has a counterpart; and the entry point under ``torchrun`` with them all
and ``mesh_data=2`` on 2 gloo ranks.

* ``dots`` keeps the weight products through the recompute: the rollout,
  the gradients and the updated parameters equal ``full``'s bit for bit
  on the CPU.  JAX's ``dots`` rollout is held to the port's at JAX's own
  bar for ``dots`` against ``full`` (``tests/test_train.py``: the same
  designs, ``nll_pred`` within rtol 1e-6), greedy on the same batch and
  parameters.
* ``debug_nans=true`` trains the tiny recipe without raising, as
  ``jax_debug_nans`` trains it; a NaN planted in one parameter raises
  ``FloatingPointError`` naming an aten op, and JAX with
  ``jax_debug_nans`` raises ``FloatingPointError`` on the same plant.
* ``profile_dir``: the trace file is written and covers exactly the
  configured epochs.
* ``PhaseTimer`` and ``Metrics`` give JAX's numbers and summary on the
  same calls and clock.
* The trainer refuses dropout alone.
"""
import json
import math
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from aline_tpu import config as jcfg
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.ops import target_mask as jmask
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.tasks.gp import GPTask as JaxGPTask
from aline_tpu.train.loop import Trainer as JaxTrainer
from aline_tpu.train.rollout import rollout as jax_rollout
from aline_tpu.utils import metrics as jmetrics
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.models.heads import gumbel_noise
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.train.loop import Trainer, check_supported
from aline_tpu_torch.train.rollout import rollout
from aline_tpu_torch.utils import metrics as tmetrics
from aline_tpu_torch.utils.debug import nan_guard
from aline_tpu_torch.utils.serialization import convert_flax_params

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
         "task.n_context_init=1", "task.n_query_init=8",
         "task.n_target_data=4", "encoder.dim_embedding=16",
         "encoder.dim_feedforward=32", "encoder.n_head=2",
         "encoder.num_layers=2", "head.num_components=4", "batch_size=4",
         "min_T=4", "T=4", "max_epoch=6", "burning_epoch=3",
         "checkpoint=0", "verbose=100"]
T = 4


def _cfgs(tmp, *extra):
    args = SMALL + list(extra) + [f"output_dir={tmp}"]
    return jcfg.parse_overrides(args), tcfg.parse_overrides(args)


# -- remat_policy=dots ------------------------------------------------------

def _epoch_state(tmp, policy):
    _, tc = _cfgs(tmp / policy, f"remat_policy={policy}", "burning_epoch=0")
    tr = Trainer(tc, device="cpu")
    tr._ensure_phase("main")
    m = tr.train_epoch(0)
    return m, {n: (p.grad.clone(), p.detach().clone())
               for n, p in tr.model.named_parameters()}


def test_dots_step_equals_full_bitwise(tmp_path):
    (m_f, full), (m_d, dots) = (_epoch_state(tmp_path, p)
                                for p in ("full", "dots"))
    for k in m_f:
        assert float(m_f[k]) == float(m_d[k]), k
    for n, (g, p) in full.items():
        assert torch.equal(g, dots[n][0]), n
        assert torch.equal(p, dots[n][1]), n


def _products(tmp, policy, remat):
    """The aten products an epoch runs: {mm+addmm, bmm} counts."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"dense": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if name in ("mm", "addmm"):
                self.n["dense"] += 1
            elif name == "bmm":
                self.n["bmm"] += 1
            return func(*args, **(kwargs or {}))

    _, tc = _cfgs(tmp / f"{policy}_{remat}", f"remat_policy={policy}",
                  f"rollout_remat={remat}", "burning_epoch=0")
    tr = Trainer(tc, device="cpu")
    tr._ensure_phase("main")
    with Count() as count:
        tr.train_epoch(0)
    return count.n


def test_dots_saves_the_dense_products_alone(tmp_path):
    """Under ``dots`` the recompute runs no dense product again (as many
    as without recompute) and every batched one (as many as ``full``)."""
    full, dots, none = (_products(tmp_path, p, r) for p, r in
                        (("full", "true"), ("dots", "true"),
                         ("full", "false")))
    assert dots["dense"] == none["dense"] < full["dense"]
    assert dots["bmm"] == full["bmm"] > none["bmm"]


def test_dots_rollout_equals_full_bitwise():
    _, tc = _cfgs("/unused")
    torch.manual_seed(0)
    model = build_model(tc, "cpu")
    jc, _ = _cfgs("/unused")
    jbatch = JaxGPTask(jc.task).sample_batch(jax.random.key(2), 4,
                                             n_query=8)
    mask = np.ones(jbatch.n_target, bool)
    batch = batch_from_numpy(jax_init_ctx_idx(
        jbatch.replace(target_mask=jnp.asarray(mask)), 1 + T))
    w_q, w_p = (torch.from_numpy(w) for w in jmask.target_weight_vectors(
        mask, "mix", "all", 4, 2))
    noise = gumbel_noise((T, 4, batch.n_points),
                         torch.Generator().manual_seed(1))
    outs = {}
    for policy in ("full", "dots"):
        model.zero_grad()
        ro = rollout(model, batch, T, w_q, w_p, noise, remat_policy=policy)
        (ro.nll_pred.mean() + ro.log_probs.mean()).backward()
        outs[policy] = (ro, {n: p.grad.clone()
                             for n, p in model.named_parameters()})
    (ro_f, g_f), (ro_d, g_d) = outs["full"], outs["dots"]
    for a, b in zip(ro_f, ro_d):
        assert torch.equal(a, b)
    for n in g_f:
        assert torch.equal(g_f[n], g_d[n]), n


def test_jax_dots_rollout_matches_port():
    jc, tc = _cfgs("/unused")
    jbatch = JaxGPTask(jc.task).sample_batch(jax.random.key(4), 5,
                                             n_query=8)
    jmodel = jax_build_model(jc)
    params = jmodel.init(jax.random.key(0), jbatch, training=False)
    mask = np.ones(jbatch.n_target, bool)
    w_q, w_p = jmask.target_weight_vectors(mask, "mix", "all", 4, 2)
    jbatch = jax_init_ctx_idx(jbatch.replace(target_mask=jnp.asarray(mask)),
                              1 + T)
    want = jax_rollout(jmodel, params, jbatch, T, jnp.asarray(w_q),
                       jnp.asarray(w_p), jax.random.key(0), training=False,
                       remat_policy="dots")
    model = build_model(tc, "cpu")
    flat = {k: np.asarray(v) for k, v in
            flatten_dict(params, sep="/").items()}
    model.load_state_dict(convert_flax_params(flat, model))
    got = rollout(model, batch_from_numpy(jbatch), T, torch.from_numpy(w_q),
                  torch.from_numpy(w_p), None, remat_policy="dots")
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.nll_pred.detach().numpy(),
                               np.asarray(want.nll_pred), rtol=1e-6)


# -- debug_nans -------------------------------------------------------------

def test_debug_nans_trains_the_tiny_recipe(tmp_path):
    _, tc = _cfgs(tmp_path, "debug_nans=true", "max_epoch=3",
                  "burning_epoch=1")
    losses = Trainer(tc, device="cpu").train()
    assert len(losses) == 3


def _plant(weight):
    with torch.no_grad():
        weight[0, 0] = float("nan")


def test_planted_nan_raises_in_both_packages(tmp_path):
    jc, tc = _cfgs(tmp_path, "max_epoch=2", "burning_epoch=1")
    tr = Trainer(tc, device="cpu")
    _plant(tr.model.embedder.x_embedder.fc1.weight)
    tr._ensure_phase("burning")
    with pytest.raises(FloatingPointError, match=r"aten\.\w+"):
        with nan_guard():
            tr.train_epoch(0)
    # without the guard the same epoch runs on and returns NaN
    assert math.isnan(float(tr.train_epoch(0)["loss"]))

    jt = JaxTrainer(jc)
    flat = flatten_dict(jax.tree_util.tree_map(np.array, jt.params),
                        sep="/")
    key = "params/embedder/x_embedder/fc1/kernel"
    flat[key][0, 0] = np.nan
    jt.params = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                               sep="/")
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            jt._ensure_phase("burning")
            jax.block_until_ready(jt.train_epoch(0)["loss"])
    finally:
        jax.config.update("jax_debug_nans", False)


def test_guard_skips_allocations_and_names_the_op():
    with nan_guard():
        e = torch.empty(1000)                  # any bits, never checked
        e.fill_(0.0)
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.tensor([-1.0]))
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


# -- profile_dir ------------------------------------------------------------

def test_profile_dir_covers_the_configured_epochs(tmp_path):
    prof = tmp_path / "prof"
    _, tc = _cfgs(tmp_path / "run", f"profile_dir={prof}",
                  "profile_epochs=2", "max_epoch=5", "burning_epoch=1")
    Trainer(tc, device="cpu").train()
    trace = prof / "trace_rank0.json"
    assert trace.exists()
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]}
    epochs = sorted(n for n in names if n and n.startswith("epoch_"))
    assert epochs == ["epoch_2", "epoch_3"]


# -- PhaseTimer, Metrics ----------------------------------------------------

def _clock(monkeypatch):
    ticks = iter(np.cumsum(np.random.default_rng(0).uniform(
        1e-3, 5e-2, size=400)).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


def test_phase_timer_and_metrics_match_jax(monkeypatch):
    timers = {}
    for name, mod in (("jax", jmetrics), ("port", tmetrics)):
        _clock(monkeypatch)
        timer = mod.PhaseTimer()
        for i in range(7):
            with timer.phase("sample"):
                pass
            with timer.phase("step", sync=i % 2 == 0):
                pass
        with timer.phase("once"):
            pass
        metrics = mod.Metrics()
        for i in range(5):
            metrics.log(loss=1.0 / (i + 1), T=i)
        timers[name] = (timer, metrics)
    (jt, jm), (tt, tm) = timers["jax"], timers["port"]
    for ph in ("sample", "step", "once", "absent"):
        assert tt.count(ph) == jt.count(ph)
        assert tt.total(ph) == jt.total(ph)
        assert tt.mean(ph) == jt.mean(ph)
        assert tt.std(ph) == jt.std(ph)
    assert tt.summary() == jt.summary()
    for k in ("loss", "T"):
        assert tm.last(k) == jm.last(k) and tm.mean(k) == jm.mean(k)


def test_trainer_times_its_phases_and_keeps_metrics(tmp_path):
    _, tc = _cfgs(tmp_path, "max_epoch=4", "burning_epoch=1", "verbose=2")
    tr = Trainer(tc, device="cpu")
    tr.train()
    assert tr.timer.count("sample") == tr.timer.count("step") == 4
    assert tr.metrics.mean("T") == T and math.isfinite(
        tr.metrics.last("loss"))


# -- what the trainer takes -------------------------------------------------

def test_trainer_refuses_dropout_alone(tmp_path):
    _, tc = _cfgs(tmp_path, "encoder.dropout=0.1")
    with pytest.raises(NotImplementedError, match="dropout"):
        check_supported(tc)
    for over in ("mesh_data=2", "remat_policy=dots", "debug_nans=true",
                 f"profile_dir={tmp_path}"):
        check_supported(_cfgs(tmp_path, over)[1])


def test_torchrun_trains_with_every_setting(tmp_path):
    """``torchrun`` (a free port on localhost) with 2 gloo ranks:
    ``mesh_data=2``, ``remat_policy=dots``, ``debug_nans`` and
    ``profile_dir``; rank 0 writes the run, each rank its trace."""
    out, prof = tmp_path / "run", tmp_path / "prof"
    args = [a for a in SMALL if not a.startswith(("max_epoch", "batch_size",
                                                  "burning_epoch"))]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "aline_tpu_torch.train", "device=cpu",
         *args, "batch_size=4", "max_epoch=4", "burning_epoch=2",
         "mesh_data=2", "remat_policy=dots", "debug_nans=true",
         f"profile_dir={prof}", "profile_epochs=1", f"output_dir={out}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for f in ("config.json", "metrics.jsonl", "model/aline.npz",
              "model/aline_burning.npz"):
        assert (out / f).exists(), f
    assert (prof / "trace_rank0.json").exists()
    assert (prof / "trace_rank1.json").exists()
    assert "takes no part" not in proc.stderr
