"""Greedy rollout tracer for the BED evaluation
(``aline_tpu/eval/traces.py``).

Runs the model greedily for T steps and returns (theta_0, designs,
outcomes).  The history INCLUDES the initial context points in front,
and the time token runs backwards, (T - t)/T, the eval direction of
``aline_tpu`` (training counts up).

With ``seq_mesh`` the candidate pool is split over the ranks of its
``seq`` axis, exactly and with no collective inside the encoder.  Under
the role mask (``ops/roles.py``) every row attends only to the context
keys and, for a query row, the selected targets and the time token; a
context or target row attends only to the context.  So each rank builds
its own sequence, [time? | the Ck context tokens, gathered by
``ctx_idx`` | its block of the pool | the targets], and computes on it
exactly the rows that the unsharded forward computes for these tokens.
The pool's x and y are small (B x n_pool x a few floats): every rank
keeps them whole.  Only the design head crosses ranks: the log-softmax
over the global pool (``all_reduce_lse``: an all-reduce MAX, then an
all-reduce SUM of the rescaled exponentials) and the greedy argmax (the
global max, then the smallest global index among the ranks that hold
it, ``torch.argmax``'s first-index rule).  ``select_design`` then runs alike on every rank.
The compact attention (``auto``, ``compact``) is covered; ``flash`` and
``naive`` are not.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from aline_tpu_torch.ops.attention import CompactKeys
from aline_tpu_torch.ops.roles import NEG_INF, build_roles
from aline_tpu_torch.parallel.collectives import (all_reduce, all_reduce_lse,
                                                   lse_init, lse_update)
from aline_tpu_torch.parallel.mesh import Mesh, pool_bounds
from aline_tpu_torch.tasks.base import Batch, init_ctx_idx, select_design
from aline_tpu_torch.train.rollout import rollout


@torch.no_grad()
def get_traces(model, task, batch: Batch, T: int, time_token: bool = False,
               seq_mesh: Optional[Mesh] = None, axis_name: str = "seq"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Roll out greedily and collect the experiment history.

    ``seq_mesh``: split the candidate pool over its ``axis_name`` axis
    (module docstring); every rank of it calls with the same batch and
    gets the same traces.

    Returns:
        theta_0: [B, ...] task-natural latents of the batch.
        x:       [B, n_context_init + T, dim_x] UNNORMALISED design
                 history (initial context first, then the chosen designs).
        y:       [B, n_context_init + T, dim_y] outcome history.
    Both come from the batch's float32 tensors, whatever the model's
    compute dtype.
    """
    n_ctx = task.n_context_init
    # the compact attention reads the index buffer: its capacity must
    # cover the whole rollout, or the attended key set stops growing
    batch = init_ctx_idx(batch, min(n_ctx + T, batch.n_points))
    if seq_mesh is not None:
        xs, ys = sharded_greedy_rollout(model, batch, T, time_token,
                                        seq_mesh, axis_name)[1:3]
    else:
        zero_w = torch.zeros(batch.n_target, device=batch.x.device)
        ro = rollout(model, batch, T, zero_w, zero_w, None,
                     time_token=time_token, time_forward=False,
                     use_remat=False)
        xs, ys = ro.xs, ro.ys
    xs = torch.cat([batch.x[:, :n_ctx], xs.transpose(0, 1)], dim=1)
    ys = torch.cat([batch.y[:, :n_ctx], ys.transpose(0, 1)], dim=1)
    return batch.theta, task.unnormalise_design(xs), ys


def _local_scores(model, batch: Batch, lo: int, hi: int) -> torch.Tensor:
    """The design scores [B, hi - lo] of pool tokens ``lo .. hi - 1``,
    from the sequence [time? | context | pool block | targets]."""
    B, Ck = batch.batch_size, batch.ctx_capacity
    count = batch.ctx_mask.sum(dim=1)
    slots = torch.arange(Ck, device=count.device)
    valid = slots[None] < count[:, None]

    def gather(v):
        return torch.gather(
            v, 1, batch.ctx_idx[..., None].expand(-1, -1, v.shape[-1]))

    # the block's context points stay query-flagged here: no key reads
    # them (the keys are the gathered copies) and the head masks them
    local = batch.replace(
        x=torch.cat([gather(batch.x), batch.x[:, lo:hi]], dim=1),
        y=torch.cat([gather(batch.y), batch.y[:, lo:hi]], dim=1),
        ctx_mask=torch.cat([valid, torch.zeros(B, hi - lo, dtype=torch.bool,
                                               device=valid.device)], dim=1),
        ctx_idx=slots[None].expand(B, Ck))
    enc = model.encoder
    t_off = int(enc.with_time_token)
    tokens = model.embedder(local)
    roles = build_roles(local.ctx_mask, tokens.shape[1] - local.n_points,
                        local.target_mask, enc.with_time_token)
    compact = CompactKeys(local.ctx_idx + t_off, valid, local.n_points, None,
                          t_off)
    z = enc(tokens, roles, local.t, compact=compact)
    z_pool = z[:, t_off + Ck:t_off + Ck + hi - lo]
    return model.head.acquisition_head(z_pool, local.t)


def sharded_greedy_rollout(model, batch: Batch, T: int, time_token: bool,
                           mesh: Mesh, axis_name: str = "seq"):
    """T greedy steps with the pool split over ``mesh``'s ``axis_name``
    axis → (idx [T, B], xs [T, B, dim_x], ys [T, B, dim_y], log_probs
    [T, B]), as ``rollout`` gives them greedily; the time token runs in
    the eval direction.  ``batch`` needs its ``ctx_idx`` buffer."""
    impl = model.encoder.impl
    if impl not in ("auto", "compact"):
        raise NotImplementedError(
            f"seq_mesh with attention_impl={impl!r}: the pool is split "
            f"only under the compact attention (auto, compact)")
    if batch.ctx_idx is None or batch.ctx_capacity <= 0:
        raise ValueError("sharded_greedy_rollout needs batch.ctx_idx "
                         "(init_ctx_idx)")
    n_pool = batch.n_points
    lo, hi = pool_bounds(n_pool, mesh, axis_name)
    group = mesh.group(axis_name)
    out = []
    for t in range(T):
        tt = (torch.full((), T - t, dtype=torch.float32,
                         device=batch.t.device) / T if time_token
              else torch.zeros((), device=batch.t.device))
        batch = batch.replace(t=tt)
        scores = _local_scores(model, batch, lo, hi)
        logits = torch.where(batch.query_mask[:, lo:hi], scores,
                             torch.full((), NEG_INF, device=scores.device))
        # log_softmax over the global pool, in torch.log_softmax's form
        # (x - max) - log(sum of exp(x - max))
        state = lse_update(lse_init(logits.shape[:1], logits.dtype,
                                    logits.device), logits, axis=-1)
        state = all_reduce_lse(state, group)
        log_probs = ((logits - state.max[:, None])
                     - torch.log(state.sumexp)[:, None])
        best = torch.amax(log_probs, dim=-1)
        gbest = all_reduce(best, dist.ReduceOp.MAX, group)
        cand = torch.where(best == gbest,
                           lo + torch.argmax(log_probs, dim=-1),
                           torch.full_like(best, n_pool, dtype=torch.long))
        idx = all_reduce(cand, dist.ReduceOp.MIN, group)
        mine = (idx >= lo) & (idx < hi)
        lp = torch.gather(log_probs, 1,
                          (idx - lo).clamp(0, hi - lo - 1)[:, None])[:, 0]
        lp = all_reduce(torch.where(mine, lp, torch.zeros_like(lp)),
                        group=group)
        batch, x_sel, y_sel = select_design(batch, idx)
        out.append((idx, x_sel, y_sel, lp))
    return tuple(torch.stack(s) for s in zip(*out))
