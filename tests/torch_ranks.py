"""Ranks for the port's multi-process tests: ``run_ranks`` starts ``n``
gloo ranks on the CPU (``aline_tpu_torch/parallel/spawn.py``), joined
through a file in a test's ``tmp_path`` (never a fixed TCP port: the
suite runs under xdist), each running one of the workers below.  Every
wait has a timeout, so a rank that hangs fails its test.  This module
imports neither JAX nor the JAX package: the ranks run the port alone,
and the JAX side of a test runs in the test's process.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from aline_tpu_torch.parallel import spawn


def run_ranks(worker, world: int, tmp_dir, *args):
    """[result of rank 0, ..., rank world-1] of ``worker(rank, world,
    *args)`` on ``world`` gloo ranks of one thread each; raises if a rank
    fails or does not answer within ``spawn.RANK_TIMEOUT_S`` seconds."""
    return spawn.run_ranks(worker, world, *args, device="cpu",
                           backend="gloo", tmp_dir=tmp_dir, num_threads=1)


# -- test_torch_mesh.py --------------------------------------------------------

def _group_ranks(group, rank):
    return [rank] if group is None else dist.get_process_group_ranks(group)


def mesh_worker(rank, world, blocks):
    """The eval meshes' rank grids and groups, get_mesh's, and
    ``sharded_logsumexp`` of ``blocks[r]`` over 2 and over 4 ranks."""
    from aline_tpu_torch.parallel.collectives import sharded_logsumexp
    from aline_tpu_torch.parallel.mesh import get_eval_mesh, get_mesh
    out = {"grids": {}}
    for shape in ((2, 2), (1, 4), (4, 1)):
        m = get_eval_mesh(*shape)
        out["grids"][shape] = dict(
            devices=m.devices.copy(), coords=m.coords,
            groups={a: _group_ranks(m.group(a), rank) for a in m.axis_names})
    m = get_mesh(0)
    out["get_mesh"] = (m.devices.copy(), m.coords,
                       m.group_all is m.group("data"))
    out["lse"] = {}
    for n in (2, 4):
        m = get_mesh(n, "contrastive")
        if m.member:
            out["lse"][n] = sharded_logsumexp(
                torch.from_numpy(blocks[n][rank]),
                m.group("contrastive")).numpy()
    return out


# -- test_torch_eig_mesh.py ----------------------------------------------------

EIG_MESHES = (("1d", 2), ("1d", 4), ("2d", (2, 2)), ("2d", (1, 4)),
              ("2d", (4, 1)))


def eig_mesh_worker(rank, world, theta_0, x, y, thetas, L, L_chunk, seed,
                    stepwise, meshes=EIG_MESHES):
    """The location-finding bounds on every mesh of ``meshes``, on the
    port's draws and on ``thetas`` (one array, or {mesh: array}):
    {(kind, shape, given): (pce, nmc)}; the 2-D ones also through
    ``eval_eig_from_history``."""
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.eval.eig import (compute_eig_from_history,
                                          eval_eig_from_history)
    from aline_tpu_torch.parallel.mesh import get_eval_mesh, get_mesh
    from aline_tpu_torch.tasks.location_finding import HiddenLocation
    task = HiddenLocation(parse_overrides(["task=location_finding"]).task)
    args = [torch.from_numpy(a) for a in (theta_0, x, y)]
    out = {}
    for kind, shape in meshes:
        mesh = (get_mesh(shape, "contrastive") if kind == "1d"
                else get_eval_mesh(*shape))
        if not mesh.member:
            continue
        given_thetas = (thetas[(kind, shape)] if isinstance(thetas, dict)
                        else thetas)
        for given in (False, True):
            th = torch.from_numpy(given_thetas) if given else None
            pce, nmc = compute_eig_from_history(
                task, *args, L, seed, L_chunk=L_chunk, stepwise=stepwise,
                thetas=th, mesh=mesh)
            out[(kind, shape, given)] = (pce.numpy(), nmc.numpy())
        if kind == "2d":
            out[(kind, shape, "eval")] = eval_eig_from_history(
                task, *args, L, seed, batch_size=4, stepwise=stepwise,
                L_chunk=L_chunk, mesh=mesh)
    return out


# -- test_torch_dp.py ----------------------------------------------------------

def _named_numpy(model, attr=None):
    return {n: (getattr(p, attr) if attr else p).detach().numpy().copy()
            for n, p in model.named_parameters()}


def dp_step_worker(rank, world, overrides, flat, batch_np, w_q, w_p, T,
                   noise):
    """One main-phase ``train_step`` on this rank's rows of the batch
    (and of ``noise``, [T, B, n] or None: greedy) over a data axis of all
    ranks, from the flax parameters ``flat``: (metrics, clipped grads,
    updated params)."""
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.models.aline import build_model
    from aline_tpu_torch.parallel.mesh import get_mesh, shard_leading_axis
    from aline_tpu_torch.tasks.base import batch_from_numpy
    from aline_tpu_torch.train.loop import ROW_FIELDS, train_step
    from aline_tpu_torch.train.optimizer import build_optimizer
    from aline_tpu_torch.utils.serialization import convert_flax_params
    cfg = parse_overrides(overrides)
    model = build_model(cfg, "cpu")
    model.load_state_dict(convert_flax_params(flat, model))
    mesh = get_mesh(world)
    batch = batch_from_numpy(batch_np)
    batch = batch.replace(**shard_leading_axis(
        {f: getattr(batch, f) for f in ROW_FIELDS
         if getattr(batch, f) is not None}, mesh))
    if noise is not None:
        m = noise.shape[1] // world
        noise = torch.from_numpy(noise[:, rank * m:(rank + 1) * m].copy())
    opt, sched = build_optimizer(cfg, model, "main")
    sel = tuple(int(i) for i in np.flatnonzero(batch_np.target_mask))
    m = train_step(model, opt, sched, batch, T, torch.from_numpy(w_q),
                   torch.from_numpy(w_p), cfg.alpha, noise, gamma=cfg.gamma,
                   sel_targets=sel, group=mesh.group("data"),
                   n_ranks=world)
    return ({k: float(v) for k, v in m.items()},
            _named_numpy(model, "grad"), _named_numpy(model))


def _list_logger(name):
    import logging
    records = []

    class _Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger(name)
    logger.handlers[:] = [_Keep()]
    logger.propagate = False
    logger.setLevel(logging.INFO)
    return logger, records


def dp_train_worker(rank, world, overrides, out_dir, odd_overrides):
    """The trainer on a data axis of all ranks: the losses of every epoch,
    the parameters after epoch 3 and at the end; then the indivisible
    batch (``odd_overrides``): its log and one epoch's loss."""
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.train.loop import Trainer
    cfg = parse_overrides(overrides + [f"output_dir={out_dir}"])
    logger, _ = _list_logger(f"dp_rank{rank}")
    tr = Trainer(cfg, logger=logger, device="cpu")
    tr._ensure_phase("burning")
    losses, after3 = [], None
    for epoch in range(cfg.max_epoch):
        losses.append(float(tr.train_epoch(epoch)["loss"]))
        if epoch == 2:
            after3 = _named_numpy(tr.model)
        if cfg.checkpoint and (epoch + 1) % cfg.checkpoint == 0:
            tr.save(epoch + 1)
    odd_cfg = parse_overrides(odd_overrides + [f"output_dir={out_dir}_odd"])
    odd_logger, records = _list_logger(f"dp_odd_rank{rank}")
    odd = Trainer(odd_cfg, logger=odd_logger, device="cpu")
    odd._ensure_phase("burning")
    odd_loss = float(odd.train_epoch(0)["loss"])
    return dict(losses=losses, after3=after3, final=_named_numpy(tr.model),
                n_data=tr.n_data, odd=dict(n_data=odd.n_data, loss=odd_loss,
                                           log=records))


# -- test_torch_seq_shard.py ---------------------------------------------------

def _sharded_traces(model, task, n, batch_np, T):
    """(x, y, log_probs, idx) of the greedy traces of ``batch_np`` with the
    pool split over the first ``n`` ranks, or None outside them."""
    from aline_tpu_torch.eval.traces import get_traces, \
        sharded_greedy_rollout
    from aline_tpu_torch.parallel.mesh import get_mesh
    from aline_tpu_torch.tasks.base import batch_from_numpy, init_ctx_idx
    mesh = get_mesh(n, "seq")
    if not mesh.member:
        return None
    batch = batch_from_numpy(batch_np)
    _, x, y = get_traces(model, task, batch, T, seq_mesh=mesh)
    b = init_ctx_idx(batch, min(task.n_context_init + T, batch.n_points))
    with torch.no_grad():
        idx, _, _, lp = sharded_greedy_rollout(model, b, T, False, mesh)
    return x.numpy(), y.numpy(), lp.numpy(), idx.numpy()


def seq_worker(rank, world, run_dir, params_npz, cases, T):
    """Greedy traces of each case ``(n_ranks, batch)`` with the pool split
    over the first ``n_ranks`` ranks: {i: (x, y, log_probs, idx)}."""
    from aline_tpu_torch.eval.traces import get_traces
    from aline_tpu_torch.parallel.mesh import get_mesh
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.tasks.base import batch_from_numpy
    from aline_tpu_torch.utils.serialization import load_model
    cfg, model = load_model(run_dir, params_npz, "cpu")
    task = build_task(cfg.task)
    out = {}
    for i, (n, batch_np) in enumerate(cases):
        traces = _sharded_traces(model, task, n, batch_np, T)
        if traces is not None:
            out[i] = traces
    # a fresh model with the time token and the design head's time feature
    model_t, task_t = time_token_model()
    batch = batch_from_numpy(cases[0][1])
    out["time"] = get_traces(model_t, task_t, batch, T, time_token=True,
                             seq_mesh=get_mesh(cases[0][0], "seq"))[1].numpy()
    # eval_boed with the pool over all ranks and the chunks over all ranks
    from aline_tpu_torch.eval.eig import eval_boed
    out["boed"] = eval_boed(model, task, **BOED, seq_mesh=get_mesh(0, "seq"),
                            mesh=get_mesh(0, "contrastive"))
    return out


TIME_TOKEN_ARGS = ["task=location_finding", "encoder.with_time_token=true",
                   "time_token=true", "encoder.dim_embedding=16",
                   "encoder.dim_feedforward=32", "encoder.n_head=2",
                   "encoder.num_layers=2", "head.num_components=4"]


def time_token_model(attention_impl="auto"):
    """(model, task) of TIME_TOKEN_ARGS under ``attention_impl``,
    initialised from seed 0."""
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.models.aline import build_model
    from aline_tpu_torch.tasks import build_task
    cfg = parse_overrides(TIME_TOKEN_ARGS
                          + [f"encoder.attention_impl={attention_impl}"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg, "cpu").eval()
    return model, build_task(cfg.task)


# eval_boed at a tiny protocol: pools of 15 tokens, 5 chunks of 64 draws
BOED = dict(T=3, L=300, M=8, batch_size=4, seed=5, n_query=14,
            L_chunk=64, stepwise=True)


# -- test_torch_seq_shard_flash.py ---------------------------------------------

def seq_core_worker(rank, world, run_dirs, params_npz, cases, T, boed):
    """The flash and dense cores with the pool split: the greedy traces of
    each case ``(run, n_ranks, batch)`` on the run directory
    ``run_dirs[run]``, {i: (x, y, log_probs, idx)}; the time-token model's
    traces under each core, {("time", impl): x}, the pool of ``cases[0]``
    over its ranks; and ``eval_boed(**boed)`` on ``run_dirs["flash"]``
    with the pool and the contrastive chunks over all ranks."""
    from aline_tpu_torch.eval.eig import eval_boed
    from aline_tpu_torch.eval.traces import get_traces
    from aline_tpu_torch.parallel.mesh import get_mesh
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.tasks.base import batch_from_numpy
    from aline_tpu_torch.utils.serialization import load_model
    runs = {k: load_model(d, params_npz, "cpu") for k, d in run_dirs.items()}
    tasks = {k: build_task(cfg.task) for k, (cfg, _) in runs.items()}
    out = {}
    for i, (run, n, batch_np) in enumerate(cases):
        traces = _sharded_traces(runs[run][1], tasks[run], n, batch_np, T)
        if traces is not None:
            out[i] = traces
    n, batch_np = cases[0][1:]
    for impl in ("flash", "naive"):
        mesh = get_mesh(n, "seq")            # collective: every rank
        if mesh.member:
            model_t, task_t = time_token_model(impl)
            out[("time", impl)] = get_traces(
                model_t, task_t, batch_from_numpy(batch_np), T,
                time_token=True, seq_mesh=mesh)[1].numpy()
    out["boed"] = eval_boed(runs["flash"][1], tasks["flash"], **boed,
                            seq_mesh=get_mesh(0, "seq"),
                            mesh=get_mesh(0, "contrastive"))
    return out


def numpy_batch(batch):
    """A picklable copy of a batch (either package's): its fields as
    numpy arrays, for ``batch_from_numpy`` in a rank."""
    from types import SimpleNamespace
    fields = ("x", "y", "ctx_mask", "target_x", "target_all", "theta",
              "target_mask", "t", "ctx_capacity", "ctx_idx")
    return SimpleNamespace(**{
        f: (None if getattr(batch, f) is None else
            getattr(batch, f) if f == "ctx_capacity" else
            np.asarray(getattr(batch, f))) for f in fields})
