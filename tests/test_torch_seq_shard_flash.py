"""Greedy BED traces with the candidate pool split over ranks under the
flash and the dense (naive) attention cores
(``aline_tpu_torch/eval/traces.py`` with ``seq_mesh``), on the committed
location-finding weights in float32, over 8 gloo ranks
(``tests/torch_ranks.py``, spawned once for the module).

* Pool 15 over 3 ranks, pool 16 over 2 and over 8 ranks: the sharded
  traces equal the unsharded port traces under the same core (the same
  designs, x and y within 1e-6, the design log-probs within ``LP_ATOL``)
  and JAX's
  ``get_traces`` under the same core on the batch that
  ``shard_query_pool`` places on a JAX mesh of as many CPU devices (the
  Pallas flash kernel in interpret mode), within 1e-6.
* ``task.n_context_init=0``, pool 16 over 8 and over 2 ranks: at step 0 no
  batch row has context, so its target rows see no key and average over
  the whole global sequence (the flash kernel's ``sum(v) / Np``, the dense
  core's softmax of ``s - 1e9``); and over 8 ranks with no target
  selected, where the pool's rows see no key either.  The same limits,
  against the unsharded port and JAX.
* The time-token model under each core, sharded against unsharded.
* ``eval_boed(seq_mesh=, mesh=)`` under flash with both meshes over the 8
  ranks gives one process's bounds within 1e-5.
"""
import copy
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from jax.sharding import Mesh as JaxMesh

from aline_tpu.eval.traces import get_traces as jax_get_traces
from aline_tpu.models.aline import build_model as jax_build_model
from aline_tpu.parallel.mesh import shard_query_pool
from aline_tpu.tasks.location_finding import HiddenLocation as JaxLocation
from aline_tpu.utils.serialization import load_config as jax_load_config
from aline_tpu_torch.eval.traces import get_traces
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.base import batch_from_numpy, init_ctx_idx
from aline_tpu_torch.train.rollout import rollout
from aline_tpu_torch.utils.serialization import LOC_100K_PARAMS, load_model
from torch_ranks import (BOED, numpy_batch, run_ranks, seq_core_worker,
                         time_token_model)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOC_RUN = os.path.join(ROOT, "checkpoints", "loc_100k")
T = 5
WORLD = 8
IMPLS = ("flash", "naive")
# (n_context_init, ranks, n_query, targets selected): pools of 15, 16
# and 16, then the pools of 16 with no initial context, and one whose
# target mask selects nothing (every row of step 0 sees no key)
POOLS = ((1, 3, 14, True), (1, 2, 15, True), (1, 8, 15, True),
         (0, 8, 16, True), (0, 2, 16, True), (0, 8, 16, False))
CASES = [(impl, i) for impl in IMPLS for i in range(len(POOLS))]
# eval_boed over all 8 ranks: pools of 16 tokens
BOED8 = dict(BOED, n_query=15)
# The design scores of these weights reach |s| ~ 134, where a float32 ulp
# is 2^-16.  A rank sums each row's keys over a shorter sequence, in other
# vector lanes than the unsharded forward, which moves a score by an ulp
# or two; a log-prob s - logsumexp(s) keeps that absolute error.  4 ulps.
LP_ATOL = 4 * 2.0 ** -16


def _run_dir(tmp, impl, n_ctx):
    with open(os.path.join(LOC_RUN, "config.json")) as f:
        run_cfg = json.load(f)
    run_cfg["dtype"] = "float32"
    run_cfg["encoder"]["attention_impl"] = impl
    run_cfg["task"]["n_context_init"] = n_ctx
    (tmp / "config.json").write_text(json.dumps(run_cfg))
    return str(tmp)


def _jax_cfg(impl, n_ctx):
    cfg = copy.deepcopy(jax_load_config(LOC_RUN))
    cfg.dtype = "float32"
    cfg.encoder.attention_impl = impl
    cfg.task.n_context_init = n_ctx
    return cfg


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    runs = {f"{impl}{n_ctx}": _run_dir(tmp_path_factory.mktemp(
        f"loc_{impl}{n_ctx}"), impl, n_ctx)
        for impl in IMPLS for n_ctx in (0, 1)}
    runs["flash"] = runs["flash1"]
    jbatches = [JaxLocation(_jax_cfg("naive", n_ctx).task).sample_batch(
        jax.random.key(20 + i), 4, n_query=nq)
        for i, (n_ctx, _, nq, _) in enumerate(POOLS)]
    jbatches = [b if sel else b.replace(
        target_mask=jax.numpy.zeros_like(b.target_mask))
        for b, (*_, sel) in zip(jbatches, POOLS)]
    cases = [(f"{impl}{POOLS[i][0]}", POOLS[i][1], numpy_batch(jbatches[i]))
             for impl, i in CASES]
    ranks = run_ranks(seq_core_worker, WORLD, tmp_path_factory.mktemp("seq"),
                      runs, str(LOC_100K_PARAMS), cases, T, BOED8)
    with np.load(LOC_100K_PARAMS) as f:
        params = unflatten_dict({k: jax.numpy.asarray(f[k])
                                 for k in f.files}, sep="/")
    return dict(ranks=ranks, cases=cases, jbatches=jbatches, params=params,
                models={k: load_model(d, LOC_100K_PARAMS, "cpu")
                        for k, d in runs.items()})


def _unsharded(seq, run, batch_np):
    """The port's unsharded traces and rollout of ``batch_np`` on ``run``."""
    cfg, model = seq["models"][run]
    task = build_task(cfg.task)
    batch = batch_from_numpy(batch_np)
    _, x, y = get_traces(model, task, batch, T)
    b = init_ctx_idx(batch, min(task.n_context_init + T, batch.n_points))
    zero = torch.zeros(batch.n_target)
    with torch.no_grad():
        ro = rollout(model, b, T, zero, zero, None, time_forward=False,
                     use_remat=False)
    return x.numpy(), y.numpy(), ro


@pytest.mark.parametrize("impl,i", CASES)
def test_sharded_traces_equal_unsharded(seq, impl, i):
    k = CASES.index((impl, i))
    run, n, batch_np = seq["cases"][k]
    assert batch_np.x.shape[1] % n == 0
    assert seq["models"][run][1].encoder.impl == impl
    x, y, ro = _unsharded(seq, run, batch_np)
    for r in range(n):
        gx, gy, glp, gidx = seq["ranks"][r][k]
        np.testing.assert_array_equal(gidx, ro.idx.numpy())
        np.testing.assert_allclose(gx, x, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gy, y, rtol=0, atol=1e-6)
        np.testing.assert_allclose(glp, ro.log_probs.numpy(), rtol=0,
                                   atol=LP_ATOL)
    for r in range(n, WORLD):
        assert k not in seq["ranks"][r]


@pytest.mark.parametrize("impl,i", CASES)
def test_sharded_traces_equal_jax(seq, impl, i):
    """JAX on the batch that ``shard_query_pool`` places over ``n`` of its
    CPU devices: GSPMD partitions (or replicates) the core, the values
    are JAX's."""
    k = CASES.index((impl, i))
    n_ctx, n = POOLS[i][:2]
    jcfg = _jax_cfg(impl, n_ctx)
    jtask = JaxLocation(jcfg.task)
    mesh = JaxMesh(np.asarray(jax.devices()[:n]), ("seq",))
    batch = shard_query_pool(seq["jbatches"][i], mesh)
    _, wx, wy = jax_get_traces(jax_build_model(jcfg), seq["params"], jtask,
                               batch, T, jax.random.key(0))
    assert np.asarray(wx).shape[1] == n_ctx + T
    for r in range(n):
        gx, gy = seq["ranks"][r][k][:2]
        np.testing.assert_allclose(gx, np.asarray(wx), rtol=0, atol=1e-6)
        np.testing.assert_allclose(gy, np.asarray(wy), rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_time_token_traces_split_the_pool_exactly(seq, impl):
    """The time token leads each rank's sequence, a key of every query
    row: the traces equal the unsharded ones under the same core."""
    model, task = time_token_model(impl)
    _, n, batch_np = seq["cases"][0]
    _, want, _ = get_traces(model, task, batch_from_numpy(batch_np), T,
                            time_token=True)
    for r in range(n):
        np.testing.assert_allclose(seq["ranks"][r][("time", impl)],
                                   want.numpy(), rtol=0, atol=1e-6,
                                   err_msg=f"rank {r}")


def test_eval_boed_under_flash_on_both_meshes_equals_one_process(seq):
    """``eval_boed(seq_mesh=, mesh=)`` under flash over 8 ranks: the same
    batches, traces and draws as one process; the bounds within 1e-5."""
    from aline_tpu_torch.eval.eig import eval_boed
    cfg, model = seq["models"]["flash"]
    want = eval_boed(model, build_task(cfg.task), **BOED8)
    for r in range(WORLD):
        got = seq["ranks"][r]["boed"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("impl", IMPLS)
def test_blind_rows_take_the_global_sequence(impl):
    """``_blind_hook`` on one rank with no context: the rows that see no key
    (the targets') get the core's output over the global sequence [pool |
    targets], without the rank's invalid context copies.  The scores are
    large: under naive a fully masked row takes softmax(s - 1e9), whose
    rounding weighs the columns once |s| >= 32, so it is not the mean of
    v there, and the hook must follow it."""
    from aline_tpu_torch.eval.traces import _blind_hook
    from aline_tpu_torch.ops.attention import dense_bias_attention
    from aline_tpu_torch.ops.flash_attention import flash_attn_fwd
    from aline_tpu_torch.ops.roles import (attention_bias, build_roles,
                                           roles_to_codes)
    B, H, dh, Ck, nb, Nt = 2, 2, 8, 3, 5, 2
    gen = torch.Generator().manual_seed(0)
    q, k, v = (20 * torch.randn(B, H, Ck + nb + Nt, dh, generator=gen)
               for _ in range(3))
    roles = build_roles(torch.zeros(B, Ck + nb, dtype=torch.bool), Nt,
                        torch.ones(Nt, dtype=torch.bool))
    groles = build_roles(torch.zeros(B, nb, dtype=torch.bool), Nt,
                         torch.ones(Nt, dtype=torch.bool))
    gq, gk, gv = (t[:, :, Ck:].contiguous() for t in (q, k, v))
    if impl == "flash":
        want = flash_attn_fwd(gq, gk, gv, *roles_to_codes(groles))[0]
    else:
        want = dense_bias_attention(gq, gk, gv, attention_bias(groles))
    hook = _blind_hook(impl, roles, 0, Ck, nb, nb, None)
    got = hook(q, k, v, torch.zeros_like(q))
    np.testing.assert_allclose(got[:, :, Ck + nb:].numpy(),
                               want[:, :, nb:].numpy(), rtol=1e-6,
                               atol=1e-5)
    # the pool rows see the targets: the hook leaves them
    assert not got[:, :, Ck:Ck + nb].any()
    mean = gv.mean(dim=2, keepdim=True).expand(-1, -1, Nt, -1)
    if impl == "naive":
        assert (want[:, :, nb:] - mean).abs().max() > 1.0
