"""Greedy BED traces with the candidate pool split over ranks
(``aline_tpu_torch/eval/traces.py`` with ``seq_mesh``) on the committed
location-finding weights in float32, over 3 gloo ranks
(``tests/torch_ranks.py``, spawned once for the module).

Pool 15 (``n_query_init=14``) over 3 ranks and pool 16 (n_query=15) over
2 ranks: the sharded traces equal the unsharded port traces (the same
designs, x and y within 1e-6, as JAX's
``test_sharded_traces_match_unsharded``) and JAX's ``get_traces`` on the
same batch and parameters; the design log-probs equal the unsharded
rollout's; so do they with the time token.  ``eval_boed`` with both meshes over the 3 ranks gives one
process's bounds.  A pool the axis does not divide raises JAX's ``ValueError``.
Under flash the rank's sequence on a mesh of one rank gives the unsharded
flash traces.
"""
import copy
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from aline_tpu.eval.traces import get_traces as jax_get_traces
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.tasks.location_finding import HiddenLocation as JaxLocation
from aline_tpu.utils.serialization import load_config as jax_load_config
from aline_tpu_torch.eval.traces import get_traces, sharded_greedy_rollout
from aline_tpu_torch.parallel.mesh import Mesh
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.base import batch_from_numpy, init_ctx_idx
from aline_tpu_torch.train.rollout import rollout
from aline_tpu_torch.utils.serialization import LOC_100K_PARAMS, load_model
from torch_ranks import (BOED, numpy_batch, run_ranks, seq_worker,
                         time_token_model)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOC_RUN = os.path.join(ROOT, "checkpoints", "loc_100k")
T = 5
WORLD = 3
CASES = ((3, 14), (2, 15))         # (ranks, n_query): pools of 15 and 16


def _f32_run(tmp):
    with open(os.path.join(LOC_RUN, "config.json")) as f:
        run_cfg = json.load(f)
    run_cfg["dtype"] = "float32"
    (tmp / "config.json").write_text(json.dumps(run_cfg))
    return str(tmp)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    run_dir = _f32_run(tmp_path_factory.mktemp("loc_f32"))
    jcfg32 = copy.deepcopy(jax_load_config(LOC_RUN))
    jcfg32.dtype = "float32"
    with np.load(LOC_100K_PARAMS) as f:
        params = unflatten_dict({k: jax.numpy.asarray(f[k])
                                 for k in f.files}, sep="/")
    jtask = JaxLocation(jcfg32.task)
    jbatches = [jtask.sample_batch(jax.random.key(10 + i), 4, n_query=nq)
                for i, (_, nq) in enumerate(CASES)]
    cases = [(n, numpy_batch(b)) for (n, _), b in zip(CASES, jbatches)]
    ranks = run_ranks(seq_worker, WORLD, tmp_path_factory.mktemp("seq"),
                      run_dir, str(LOC_100K_PARAMS), cases, T)
    cfg, model = load_model(run_dir, LOC_100K_PARAMS, "cpu")
    return dict(ranks=ranks, cases=cases, jbatches=jbatches,
                jmodel=jax_build_model(jcfg32), params=params, jtask=jtask,
                model=model, task=build_task(cfg.task))


@pytest.mark.parametrize("i", range(len(CASES)))
def test_sharded_traces_equal_unsharded(seq, i):
    n, batch_np = seq["cases"][i]
    assert batch_np.x.shape[1] % n == 0
    batch = batch_from_numpy(batch_np)
    _, x, y = get_traces(seq["model"], seq["task"], batch, T)
    b = init_ctx_idx(batch, 1 + T)
    zero = torch.zeros(batch.n_target)
    with torch.no_grad():
        ro = rollout(seq["model"], b, T, zero, zero, None,
                     time_forward=False, use_remat=False)
    for r in range(n):
        gx, gy, glp, gidx = seq["ranks"][r][i]
        np.testing.assert_array_equal(gidx, ro.idx.numpy())
        np.testing.assert_allclose(gx, x.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(gy, y.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(glp, ro.log_probs.numpy(), rtol=1e-5,
                                   atol=1e-5)
    for r in range(n, WORLD):
        assert i not in seq["ranks"][r]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_sharded_traces_equal_jax(seq, i):
    n = seq["cases"][i][0]
    _, wx, wy = jax_get_traces(seq["jmodel"], seq["params"], seq["jtask"],
                               seq["jbatches"][i], T, jax.random.key(0))
    for r in range(n):
        gx, gy = seq["ranks"][r][i][:2]
        np.testing.assert_allclose(gx, np.asarray(wx), rtol=0, atol=1e-6)
        np.testing.assert_allclose(gy, np.asarray(wy), rtol=0, atol=1e-6)


def test_time_token_traces_split_the_pool_exactly(seq):
    """The time token leads each rank's sequence and the design head reads
    the time feature: the traces equal the unsharded ones."""
    model, task = time_token_model()
    n, batch_np = seq["cases"][0]
    _, want, _ = get_traces(model, task, batch_from_numpy(batch_np), T,
                            time_token=True)
    for r in range(n):
        np.testing.assert_allclose(seq["ranks"][r]["time"], want.numpy(),
                                   rtol=0, atol=1e-6, err_msg=f"rank {r}")


def test_eval_boed_on_both_meshes_equals_one_process(seq):
    """``eval_boed(seq_mesh=, mesh=)`` over 3 ranks: the same batches,
    traces and draws as one process; the bounds within 1e-5."""
    from aline_tpu_torch.eval.eig import eval_boed
    want = eval_boed(seq["model"], seq["task"], **BOED)
    for r in range(WORLD):
        got = seq["ranks"][r]["boed"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{k} rank {r}")


def _mesh(n):
    return Mesh(("seq",), np.arange(n), 0, {}, None)


def test_indivisible_pool_raises_jax_error(seq):
    batch = init_ctx_idx(batch_from_numpy(seq["cases"][0][1]), 1 + T)
    with pytest.raises(ValueError, match="candidate pool of 15 tokens is "
                       "not divisible by the 2-way 'seq' mesh axis"):
        sharded_greedy_rollout(seq["model"], batch, T, False, _mesh(2))


def test_flash_pool_on_one_rank_equals_unsharded(seq, tmp_path):
    """The rank's own sequence under flash, [context copies in index order
    | the pool | targets], on a mesh of one rank: the unsharded flash
    traces (``tests/test_torch_seq_shard_flash.py`` splits the pool)."""
    with open(os.path.join(LOC_RUN, "config.json")) as f:
        run_cfg = json.load(f)
    run_cfg["dtype"] = "float32"
    run_cfg["encoder"]["attention_impl"] = "flash"
    (tmp_path / "config.json").write_text(json.dumps(run_cfg))
    _, model = load_model(str(tmp_path), LOC_100K_PARAMS, "cpu")
    batch = init_ctx_idx(batch_from_numpy(seq["cases"][0][1]), 1 + T)
    zero = torch.zeros(batch.n_target)
    with torch.no_grad():
        ro = rollout(model, batch, T, zero, zero, None, time_forward=False,
                     use_remat=False)
        idx, xs, ys, lp = sharded_greedy_rollout(model, batch, T, False,
                                                 _mesh(1))
    np.testing.assert_array_equal(idx.numpy(), ro.idx.numpy())
    np.testing.assert_allclose(xs.numpy(), ro.xs.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ys.numpy(), ro.ys.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(lp.numpy(), ro.log_probs.numpy(), rtol=1e-5,
                               atol=1e-5)
