"""The port's training slice (``aline_tpu_torch.train``, the target masks,
the config parser, the init and the param export) against the JAX
package, at a small size: 2 layers, d=16, H=2, F=32, C=4, B<=6, T<=4.

Tolerances: 1e-6 for the loss and the optimizer, where both sides do the
same float32 arithmetic on the same numbers; 1e-4 for a whole training
step, where two frameworks' matmuls sum in different orders through the
model, the rollout and the backward pass.  Masks, designs and the
(phase, T, mask) sequence are compared exactly; resume bitwise.
"""
import dataclasses
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from aline_tpu import config as jcfg
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.ops import target_mask as jmask
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.tasks.gp import GPTask as JaxGPTask
from aline_tpu.train import loss as jloss
from aline_tpu.train import optimizer as jopt
from aline_tpu.train.loop import Trainer as JaxTrainer
from aline_tpu.train.rollout import RolloutOutputs as JaxRolloutOutputs
from aline_tpu.train.rollout import rollout as jax_rollout
from aline_tpu_torch import config as tcfg
from aline_tpu_torch import eval_al
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.ops import gmm_head_kernel as ghk
from aline_tpu_torch.ops import target_mask as tmask
from aline_tpu_torch.tasks.base import batch_from_numpy
from aline_tpu_torch.train import loss as tloss
from aline_tpu_torch.train import optimizer as topt
from aline_tpu_torch.train.__main__ import main as train_main
from aline_tpu_torch.train.loop import Trainer, train_step
from aline_tpu_torch.train.rollout import RolloutOutputs, rollout
from aline_tpu_torch.utils import serialization
from aline_tpu_torch.utils.serialization import (
    convert_flax_params,
    export_flax_params,
)

torch.set_num_threads(1)

SMALL = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
         "task.n_context_init=1", "task.n_query_init=8",
         "task.n_target_data=4", "encoder.dim_embedding=16",
         "encoder.dim_feedforward=32", "encoder.n_head=2",
         "encoder.num_layers=2", "head.num_components=4", "batch_size=4",
         "min_T=4", "T=4", "max_epoch=6", "burning_epoch=3",
         "checkpoint=0", "verbose=100"]


def _cfgs(tmp=None, *extra):
    """The same overrides through both packages' parsers."""
    args = SMALL + list(extra)
    if tmp is not None:
        args.append(f"output_dir={tmp}")
    return jcfg.parse_overrides(args), tcfg.parse_overrides(args)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def test_parse_overrides_matches_jax():
    args = SMALL + ["task.mask_type=[split,all]", "eval=bed", "min_T=9",
                    "rollout_remat=false", "lr=3e-4", "gamma=0.9"]
    assert tcfg.to_dict(tcfg.parse_overrides(args)) == \
        jcfg.to_dict(jcfg.parse_overrides(args))
    for task in ("ces", "psychometric", "hpo"):
        assert tcfg.to_dict(tcfg.parse_overrides([f"task={task}"])) == \
            jcfg.to_dict(jcfg.parse_overrides([f"task={task}"]))
    assert tcfg.to_dict(tcfg.parse_overrides(["task=benchmark"])) == \
        jcfg.to_dict(jcfg.parse_overrides(["task=benchmark"]))
    with pytest.raises(KeyError, match="nonexistent"):
        tcfg.parse_overrides(["task.nonexistent=3"])


# -- (b) target masks -----------------------------------------------------

@pytest.mark.parametrize("mask_type,emb,kw", [
    ("all", "mix", {}), ("none", "data", {}),
    ("partial", "data", dict(n_selected_targets=3)),
    ("partial", "theta", dict(n_selected_targets=1)),
    ("predefined", "theta", dict(predefined_masks=[[0, 0, 1, 1], [1, 1, 0, 0],
                                                   [1, 0, 1, 0]],
                                 predefined_mask_weights=[1.0, 2.0, 0.5])),
    ("predefined", "theta", dict(predefined_masks=[[0, 1, 1, 1],
                                                   [1, 1, 0, 0]])),
    ("split", "mix", {}), ("split", "mix", dict(attend_to="theta")),
])
def test_target_masks_match_jax(mask_type, emb, kw):
    n_data, n_theta = (0, 4) if emb == "theta" else (4, 2)
    rj, rt = random.Random(11), random.Random(11)
    for _ in range(50):
        want = jmask.create_target_mask(mask_type, emb, n_data, n_theta,
                                        rng=rj, **kw)
        got = tmask.create_target_mask(mask_type, emb, n_data, n_theta,
                                       rng=rt, **kw)
        np.testing.assert_array_equal(got, want)
        for g, w in zip(
                tmask.target_weight_vectors(got, emb, mask_type, n_data,
                                            n_theta),
                jmask.target_weight_vectors(want, emb, mask_type, n_data,
                                            n_theta)):
            np.testing.assert_array_equal(g, w)


# -- (c) loss ---------------------------------------------------------------

def _rollout_outputs(seed, T=5, B=6):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(log_probs=rng.normal(size=(T, B)).astype(f32),
                nll_query=rng.normal(size=(T, B)).astype(f32),
                nll_pred=rng.normal(size=(T, B)).astype(f32),
                idx=rng.integers(0, 9, size=(T, B)),
                xs=rng.normal(size=(T, B, 1)).astype(f32),
                ys=rng.normal(size=(T, B, 1)).astype(f32),
                final_ctx_mask=rng.random((B, 9)) < 0.5)


@pytest.mark.parametrize("gamma,alpha", [(1.0, 0.0), (0.9, 0.7)])
def test_losses_match_jax(gamma, alpha):
    ro = _rollout_outputs(int(gamma * 10))
    _, want = jloss.total_loss(
        JaxRolloutOutputs(**{k: jnp.asarray(v) for k, v in ro.items()}),
        gamma, jnp.float32(alpha))
    _, got = tloss.total_loss(
        RolloutOutputs(**{k: torch.from_numpy(np.asarray(v))
                          for k, v in ro.items()}), gamma, alpha)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-6, k)


# -- (d) optimizer ----------------------------------------------------------

@pytest.fixture(scope="module")
def small_params():
    """Random-init flax params of the small config, perturbed so that no
    bias is zero and no LayerNorm scale is one."""
    jc, tc = _cfgs()
    jbatch = JaxGPTask(jc.task).sample_batch(jax.random.key(7), 4,
                                             n_query=8)
    params = jax_build_model(jc).init(jax.random.key(0), jbatch,
                                      training=False)
    rng = np.random.default_rng(8)
    flat = {k: (np.asarray(v) + 0.1 * rng.normal(size=v.shape))
            .astype(np.float32)
            for k, v in flatten_dict(params, sep="/").items()}
    return flat


def _jax_tree(flat):
    return unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                          sep="/")


def _port_model(tc, flat):
    model = build_model(tc, "cpu")
    model.load_state_dict(convert_flax_params(flat, model))
    return model


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_and_partition_match_optax(small_params, warmup):
    for steps in (1, 7, 20):
        want = jopt._cosine(1e-3, steps, warmup)
        got = topt.cosine_factor(steps, warmup)
        for t in range(steps + 4):
            _close(1e-3 * got(t), want(t), 1e-9, f"steps={steps} t={t}")
    labels = {k: v for k, v in flatten_dict(
        jopt.predictor_partition(_jax_tree(small_params)), sep="/").items()}
    _, tc = _cfgs()
    model = _port_model(tc, small_params)
    names = {n for n, _ in model.named_parameters()}
    for k, label in labels.items():
        tkey = _torch_key(k)
        assert tkey in names
        assert topt.is_predictor(tkey) == (label == "predictor"), k
    assert sum(label == "predictor" for label in labels.values()) == 4


def _torch_key(flax_key):
    return serialization._torch_key(flax_key)[0]


def test_optimizer_matches_optax(small_params):
    """5 burning then 5 main steps on a fixed gradient sequence (scaled so
    that the inf-norm clip acts), AdamW against optax with the clip."""
    jc, tc = _cfgs(None, "max_epoch=12", "burning_epoch=5", "lr_warmup=2")
    rng = np.random.default_rng(3)
    grads = [{k: (rng.normal(size=v.shape) * (3.0 if i % 2 else 0.3))
              .astype(np.float32) for k, v in small_params.items()}
             for i in range(10)]
    params = _jax_tree(small_params)
    model = _port_model(tc, small_params)
    named = dict(model.named_parameters())
    for phase, steps in (("burning", grads[:5]), ("main", grads[5:])):
        tx, _ = jopt.build_optimizer(jc, params, phase)
        state = tx.init(params)
        opt, sched = topt.build_optimizer(tc, model, phase)
        for g in steps:
            updates, state = tx.update(_jax_tree(g), state, params)
            params = optax.apply_updates(params, updates)
            for k, v in g.items():
                t = named[_torch_key(k)]
                t.grad = torch.from_numpy(v.T.copy() if k.endswith("kernel")
                                          else v.copy())
            topt.clip_by_inf_norm(model.parameters(), 1.0)
            opt.step()
            sched.step()
        want = convert_flax_params(flatten_dict(params, sep="/"), model)
        for k, v in model.state_dict().items():
            _close(v, want[k], 1e-6, f"{phase} {k}")


# -- (e) one training step --------------------------------------------------

def test_train_step_matches_jax(small_params):
    """Greedy rollout (equal indices asserted) → loss → grads → clip →
    AdamW, main phase (both losses, two lr groups), from the same params
    on a JAX-drawn batch with a fixed split mask."""
    T = 4
    jc, tc = _cfgs(None, "max_epoch=20", "burning_epoch=5")
    jbatch = JaxGPTask(jc.task).sample_batch(jax.random.key(5), 4,
                                             n_query=8)
    mask = np.zeros(jbatch.n_target, bool)
    mask[:4] = True                                   # the data targets
    jbatch = jax_init_ctx_idx(jbatch.replace(target_mask=jnp.asarray(mask)),
                              1 + T)
    w_q, w_p = jmask.target_weight_vectors(mask, "mix", "split", 4, 2)
    sel = tuple(range(4))
    jmodel = jax_build_model(jc)
    params = _jax_tree(small_params)

    def loss_fn(p):
        ro = jax_rollout(jmodel, p, jbatch, T, jnp.asarray(w_q),
                         jnp.asarray(w_p), jax.random.key(0),
                         training=False, sel_targets=sel)
        loss, m = jloss.total_loss(ro, jc.gamma, jnp.float32(jc.alpha))
        return loss, (m, ro.idx)

    (loss, (jm, jidx)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    tx, _ = jopt.build_optimizer(jc, params, "main")
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    model = _port_model(tc, small_params)
    batch = batch_from_numpy(jbatch)
    with torch.no_grad():
        ro = rollout(model, batch, T, torch.from_numpy(w_q),
                     torch.from_numpy(w_p), sel_targets=sel)
    np.testing.assert_array_equal(ro.idx.numpy(), np.asarray(jidx))
    opt, sched = topt.build_optimizer(tc, model, "main")
    m = train_step(model, opt, sched, batch, T, torch.from_numpy(w_q),
                   torch.from_numpy(w_p), tc.alpha, None, gamma=tc.gamma,
                   sel_targets=sel)
    for k in jm:
        _close(m[k], jm[k], 1e-4, k)
    _close(m["grad_norm"], optax.global_norm(jgrads), 1e-4)
    flat_g = flatten_dict(jgrads, sep="/")
    scale = min(1.0, 1.0 / (max(float(jnp.max(jnp.abs(g)))
                                for g in flat_g.values()) + 1e-6))
    want_g = convert_flax_params(flat_g, model)
    for k, p in model.named_parameters():             # the clipped grads
        _close(p.grad, want_g[k] * scale, 1e-4, f"grad {k}")
    # Entries that shift every logit of a softmax alike (the score head's
    # output bias, the key third of each qkv bias) move no loss: their
    # gradient is rounding noise in both frameworks, and Adam's first
    # step, which divides a gradient by its own size, turns that noise
    # into an O(lr) update of either sign.  They are held to a zero
    # gradient instead.
    invariant = _shift_invariant(model)
    want_p = convert_flax_params(flatten_dict(jnew, sep="/"), model)
    for k, v in model.state_dict().items():
        keep = slice(None)
        if k in invariant:
            keep = ~invariant[k]
            assert model.get_parameter(k).grad[invariant[k]].abs().max() \
                < 1e-6, k
            assert want_g[k][invariant[k]].abs().max() < 1e-6, k
        _close(v[keep], want_p[k][keep], 1e-4, f"param {k}")


def _shift_invariant(model):
    """{parameter name: mask of its entries that shift every logit of a
    softmax alike}."""
    out = {}
    for name, p in model.named_parameters():
        if name.endswith("acquisition_head.predictor_fc2.bias"):
            out[name] = torch.ones(p.shape, dtype=torch.bool)
        elif name.endswith("self_attn.qkv_proj.bias"):
            d = p.numel() // 3
            out[name] = torch.arange(p.numel()) // d == 1
    return out


# -- (f) the epoch sequence -------------------------------------------------

def _record_masks(trainer, phase_attr, seen):
    inner = trainer._epoch_mask_and_weights

    def wrapped():
        mask, w_q, w_p = inner()
        seen.append((getattr(trainer, phase_attr), mask.tolist()))
        return mask, w_q, w_p
    trainer._epoch_mask_and_weights = wrapped


def test_epoch_sequence_matches_jax(tmp_path):
    """The (phase, T, mask) sequence over a burning→main run, with T and
    the mask type drawn from several choices."""
    extra = ("min_T=2", "task.mask_type=[split,all,none]", "batch_size=2",
             "max_epoch=8")
    jc, _ = _cfgs(tmp_path / "jax", *extra)
    _, tc = _cfgs(tmp_path / "port", *extra)
    jt = JaxTrainer(jc)
    jseen, tseen = [], []
    _record_masks(jt, "_phase", jseen)

    def fake_step(T, sel=None):                       # no rollout, no compile
        return lambda params, opt_state, key, *a: (params, opt_state, key,
                                                   {})
    jt._get_step = fake_step
    jT = [jt.train_epoch(e)["T"] for e in range(jc.max_epoch)]
    tt = Trainer(tc, device="cpu")
    _record_masks(tt, "phase", tseen)
    tT = [tt.train_epoch(e)["T"] for e in range(tc.max_epoch)]
    assert tT == jT and len(set(jT)) > 1
    assert tseen == jseen
    assert {p for p, _ in tseen} == {"burning", "main"}


# -- (g) init ---------------------------------------------------------------

def test_fresh_model_initialised_like_flax():
    """Flagship widths (d=32, F=128, C=10, 3 layers): each parameter's
    mean and std against a flax init within 5 standard errors; biases and
    LayerNorm offsets exactly zero, LayerNorm scales exactly one."""
    args = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2"]
    jc, tc = jcfg.parse_overrides(args), tcfg.parse_overrides(args)
    jbatch = JaxGPTask(jc.task).sample_batch(jax.random.key(1), 2,
                                             n_query=4)
    flax_flat = {k: np.asarray(v) for k, v in flatten_dict(
        jax_build_model(jc).init(jax.random.key(2), jbatch,
                                 training=False), sep="/").items()}
    torch.manual_seed(3)
    port = export_flax_params(build_model(tc, "cpu"))
    assert set(port) == set(flax_flat)
    for k, want in flax_flat.items():
        got = port[k]
        assert got.shape == want.shape, k
        leaf = k.rsplit("/", 1)[1]
        if leaf in ("bias", "heads_b1", "heads_b2"):
            assert not got.any() and not want.any(), k
            continue
        if leaf == "scale":
            assert (got == 1).all() and (want == 1).all(), k
            continue
        n, sd = got.size, want.std()
        assert abs(got.mean() - want.mean()) < 5 * sd * math.sqrt(2 / n), k
        assert abs(got.std() - sd) < 5 * sd * math.sqrt(1 / n), k
    fan = {"heads_w1": 10 * 32, "heads_w2": 10 * 128}
    for name, fan_in in fan.items():
        got = port[f"params/head/target_head/{name}"]
        assert abs(got.std() * math.sqrt(fan_in) - 1) < 0.05, name


# -- port-only ------------------------------------------------------------

def test_export_flax_params_round_trips(small_params):
    _, tc = _cfgs()
    model = _port_model(tc, small_params)
    flat = export_flax_params(model)
    assert set(flat) == set(small_params)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, small_params[k], err_msg=k)
    again = convert_flax_params(flat, model)
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k


def test_remat_gives_the_same_gradients(tmp_path):
    """A sampled step with per-step recompute against one without, from
    the same seed: the recomputed steps must draw the same designs."""
    runs = []
    for remat in ("true", "false"):
        _, tc = _cfgs(tmp_path / remat, f"rollout_remat={remat}",
                      "burning_epoch=0")
        tr = Trainer(tc, device="cpu")
        tr._ensure_phase("main")
        tr.train_epoch(0)
        runs.append({n: (p.grad.clone(), p.detach().clone())
                     for n, p in tr.model.named_parameters()})
    for n, (g, p) in runs[0].items():
        assert g.abs().max() > 0 or "theta" in n, n
        torch.testing.assert_close(g, runs[1][n][0], rtol=0, atol=1e-7)
        torch.testing.assert_close(p, runs[1][n][1], rtol=0, atol=1e-7)


@pytest.mark.parametrize("remat", [True, False])
def test_head_calls_per_rollout_step(small_params, monkeypatch, remat):
    """The count chip_smoke.py derives: per step one forward of the target
    head (the pool's posterior is not computed in training) and one more
    when the step is recomputed, and one backward."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ghk.gmm_head_fwd_plain, ghk.gmm_head_bwd_plain

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(ghk, "gmm_head_fwd_plain", count("fwd", fwd))
    monkeypatch.setattr(ghk, "gmm_head_bwd_plain", count("bwd", bwd))
    _, tc = _cfgs(None, f"rollout_remat={str(remat).lower()}")
    tr = Trainer(tc, device="cpu", model=_port_model(tc, small_params))
    tr._ensure_phase("burning")
    T = tr.train_epoch(0)["T"]
    assert calls == {"fwd": T * (2 if remat else 1), "bwd": T}


def test_resume_is_bitwise_exact(tmp_path):
    """6 epochs straight against 3, a checkpoint, a new Trainer restored
    from it and 3 more; the burning snapshot appears at the boundary."""
    common = ("min_T=2", "max_epoch=6", "burning_epoch=3")
    _, straight = _cfgs(tmp_path / "a", *common)
    a = Trainer(straight, device="cpu")
    a.train()
    _, first = _cfgs(tmp_path / "b", *common)
    b = Trainer(first, device="cpu")
    b._ensure_phase("burning")
    for epoch in range(3):
        b.train_epoch(epoch)
    b.save(3)
    assert not (tmp_path / "b" / "model" / "aline_burning.npz").exists()
    _, rest = _cfgs(tmp_path / "b", *common, "load_checkpoint=true")
    resumed = Trainer(rest, device="cpu")
    resumed.train()
    assert resumed.start_epoch == 3
    for (n, p), q in zip(a.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(p, q), n
    with np.load(tmp_path / "a" / "model" / "aline_burning.npz") as x, \
            np.load(tmp_path / "b" / "model" / "aline_burning.npz") as y:
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_trainer_refuses_what_is_not_ported(tmp_path):
    for over, what in (("encoder.dropout=0.1", "dropout"),
                       ("mesh_data=2", "mesh"),
                       ("remat_policy=dots", "remat_policy")):
        _, tc = _cfgs(tmp_path, over)
        with pytest.raises(NotImplementedError, match=what):
            Trainer(tc, device="cpu")
    # eval.EIG is ported: the trainer takes it and calls the hook every
    # ``verbose`` epochs, and only with eval.EIG
    calls = []

    def hook(trainer, epoch):
        calls.append((trainer, epoch))
        return {"pce_mean": 1.0, "nmc_mean": 2.0}

    _, tc = _cfgs(tmp_path, "eval.EIG=true", "max_epoch=5", "verbose=2")
    trainer = Trainer(tc, device="cpu")
    trainer.train(eval_hook=hook)
    assert [e for _, e in calls] == [0, 2, 4]
    assert all(t is trainer for t, _ in calls)
    _, tc = _cfgs(tmp_path, "max_epoch=3", "verbose=1")
    Trainer(tc, device="cpu").train(eval_hook=hook)
    assert len(calls) == 3


def test_cli_trains_and_eval_reads_the_model(tmp_path, capsys):
    run = tmp_path / "run"
    train_main(["device=cpu", *SMALL, "max_epoch=8", "burning_epoch=4",
                "checkpoint=4", "verbose=4", "file_name=aline.pth",
                f"output_dir={run}"])
    for name in ("config.json", "metrics.jsonl", "ckpt.pt",
                 "model/aline.npz", "model/aline_burning.npz"):
        assert (run / name).exists(), name
    assert list((run / "logs").iterdir())
    cfg = tcfg.load_config(str(run))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        tcfg.parse_overrides([*SMALL, "max_epoch=8", "burning_epoch=4",
                              "checkpoint=4", "verbose=4",
                              "file_name=aline.pth", f"output_dir={run}"]))
    eval_al.main([str(run), "--params", str(run / "model" / "aline.npz"),
                  "--device", "cpu", "--batch-size", "2", "--T", "2",
                  "--n-query", "6"])
    assert "final log_prob" in capsys.readouterr().out
    assert (run / "eval" / "al_curves.npz").exists()
