"""The HPO-B task (``aline_tpu_torch/tasks/hpo.py``) against the JAX
package's: its batches are drawn on the host from a numpy ``Generator``,
so under the same seed they are JAX's bit for bit: the files as read,
``sample_batch`` (with and without ``normalize_y``), the benchmark's
fixed test set of every meta-dataset in ``data/HPOB``, and the trainer's
stream (the JAX trainer draws one batch of 2 to initialise its
parameters, and so does the port's).  And the greedy policy of
hpo_rpart_45k on the fixed test set, in its bf16, follows JAX's.
"""
import os

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from aline_tpu import config as jcfg
from aline_tpu.eval.al_curves import al_rollout_curves as jax_rollout
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.tasks.base import init_ctx_idx as jax_init_ctx_idx
from aline_tpu.tasks.base import select_design as jax_select_design
from aline_tpu.tasks.hpo import HPOTask as JaxHPO
from aline_tpu.tasks.hpob_native import load_hpob_arrays as jax_load
from aline_tpu.train.loop import Trainer as JaxTrainer
from aline_tpu.utils.serialization import load_config as jax_load_config
from aline_tpu_torch import config as tcfg
from aline_tpu_torch.eval.al_curves import al_rollout_curves
from aline_tpu_torch.tasks import batch_from_numpy, build_task
from aline_tpu_torch.tasks.hpo import DATA_DIR, HPOTask, load_hpob_arrays
from aline_tpu_torch.train import loop
from aline_tpu_torch.utils.serialization import BANKED_RUNS, load_model

torch.set_num_threads(1)
META = ("glmnet", "ranger", "rpart", "svm", "xgboost")


def _tasks(*extra):
    args = ["task=hpo", *extra]
    return (JaxHPO(jcfg.parse_overrides(args).task),
            build_task(tcfg.parse_overrides(args).task))


def _assert_batches_equal(jb, tb):
    for name in ("x", "y", "target_x", "target_all", "ctx_mask",
                 "target_mask"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert tb.theta is None and jb.theta is None


@pytest.mark.parametrize("meta", META + ("ranger_shift",))
def test_files_read_as_jax_reads_them(meta):
    path = os.path.join(DATA_DIR, "HPOB", f"{meta}.json")
    want, got = jax_load(path), load_hpob_arrays(path)
    assert list(got) == list(want)
    for did in want:
        for g, w in zip(got[did], want[did]):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("normalize_y", [False, True])
@pytest.mark.parametrize("meta", ["rpart", "xgboost"])
def test_sample_batch_is_jax_bitwise(meta, normalize_y):
    jt, tt = _tasks(f"task.meta_dataset={meta}",
                    f"task.normalize_y={str(normalize_y).lower()}",
                    "task.n_target_data=20")
    assert isinstance(tt, HPOTask) and tt.dim_x == jt.dim_x
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    for n_query in (None, 30):
        jb = jt.sample_batch(rj, 6, n_query=n_query)
        tb = tt.sample_batch(rt, 6, n_query=n_query)
        _assert_batches_equal(jb, tb)
    assert rj.bit_generator.state == rt.bit_generator.state


@pytest.mark.parametrize("meta", META + ("ranger_shift",))
def test_test_set_is_jax_bitwise(meta):
    jt, tt = _tasks(f"task.meta_dataset={meta}")
    want = jt.hpob.sample_test_set(5, 100, 100)
    got = tt.hpob.sample_test_set(5, 100, 100)
    assert got[0].shape == (30, 5, tt.dim_x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_trainer_draws_jax_trainers_batches(tmp_path, monkeypatch):
    args = ["task=hpo", "task.meta_dataset=rpart", "task.n_query_init=12",
            "task.n_target_data=8", "encoder.dim_embedding=16",
            "encoder.dim_feedforward=32", "encoder.n_head=2",
            "encoder.num_layers=1", "head.num_components=3", "batch_size=4",
            "min_T=2", "T=3", "max_epoch=4", "burning_epoch=1",
            f"output_dir={tmp_path}"]
    jtr = JaxTrainer(jcfg.parse_overrides(args))
    ttr = loop.Trainer(tcfg.parse_overrides(args), device="cpu")
    assert (ttr.nprng.bit_generator.state == jtr.nprng.bit_generator.state)
    seen = []

    def capture(model, optimizer, scheduler, batch, T, *a, **kw):
        seen.append(batch)
        return {"loss": torch.zeros(())}

    monkeypatch.setattr(loop, "train_step", capture)
    for epoch in (0, 1):                 # burning (n_query = T), then main
        ttr.train_epoch(epoch)
        T = jtr.pyrng.randint(jtr.cfg.min_T, jtr.cfg.T)
        n_query = jtr.cfg.T if epoch == 0 else jtr.cfg.task.n_query_init
        jb = jtr._sample_batch(jax.random.key(0), 4, n_query)
        jtr._epoch_mask_and_weights()
        np.testing.assert_array_equal(seen[-1].x.numpy(), np.asarray(jb.x))
        np.testing.assert_array_equal(seen[-1].y.numpy(), np.asarray(jb.y))
        np.testing.assert_array_equal(seen[-1].target_all.numpy(),
                                      np.asarray(jb.target_all))
        assert seen[-1].n_points == 5 + n_query and T >= 2


def test_dim_x_comes_from_the_data():
    cfg = tcfg.parse_overrides(["task=hpo", "task.meta_dataset=svm"]).task
    assert cfg.dim_x == 9
    task = build_task(cfg)
    assert cfg.dim_x == task.dim_x == 4
    with pytest.raises(NotImplementedError, match="real data"):
        task.simulate(None, None)


def test_policy_on_the_test_set_follows_jax_in_bf16():
    """hpo_rpart_45k in its own bf16 on 4 rows of the fixed test set
    (n_query=30, n_target=20, T=4), JAX without jit: the policy's indices
    equal JAX's except where a row leaves at an exact tie of JAX's bf16
    design scores, and the curves within 2e-2 on the rows that stay (as
    tests/test_torch_bf16_slice.py holds the flagship)."""
    run = os.path.join(DATA_DIR.parent, "checkpoints", "hpo_rpart_45k")
    T = 4
    jcfg_run = jax_load_config(run)
    jtask = JaxHPO(jcfg_run.task)
    splits = [a[:4] for a in jtask.hpob.sample_test_set(5, 30, 20)]
    jbatch = jtask._pack_batch(
        jax.numpy.asarray(np.concatenate([splits[0], splits[2]], 1)),
        jax.numpy.asarray(np.concatenate([splits[1], splits[3]], 1)),
        jax.numpy.asarray(splits[4]), jax.numpy.asarray(splits[5]),
        jax.numpy.zeros((4, 0, 1)), None)
    jmodel = jax_build_model(jcfg_run)
    with np.load(BANKED_RUNS["hpo_rpart_45k"][1]) as f:
        params = unflatten_dict({k: jax.numpy.asarray(f[k])
                                 for k in f.files}, sep="/")
    with jax.disable_jit():
        want = jax_rollout(jmodel, params, jbatch, T, jax.random.key(0))
    _, model = load_model(run, BANKED_RUNS["hpo_rpart_45k"][1], "cpu")
    got = al_rollout_curves(model, batch_from_numpy(jbatch), T)
    gidx, widx = got["idx"].numpy(), np.asarray(want["idx"])
    differs = (gidx != widx).any(axis=1)
    for r in np.flatnonzero(differs):
        t = int(np.argmax(gidx[r] != widx[r]))
        b = jax_init_ctx_idx(jbatch, min(5 + T, jbatch.n_points))
        for s in range(t):
            b = jax_select_design(b, jax.numpy.asarray(widx[:, s]))[0]
        with jax.disable_jit():
            zt = np.asarray(jmodel.apply(params, b,
                                         training=False).design_out.zt)
        assert zt[r, gidx[r, t]] == zt[r, widx[r, t]], (r, t)
    assert (~differs).sum() >= 3
    for key in ("log_prob", "rmse"):
        np.testing.assert_allclose(got[key].numpy()[~differs],
                                   np.asarray(want[key])[~differs],
                                   rtol=2e-2, atol=2e-2, err_msg=key)
