"""Greedy rollout tracer for the BED evaluation
(``aline_tpu/eval/traces.py``).

Runs the model greedily for T steps and returns (theta_0, designs,
outcomes).  The history INCLUDES the initial context points in front,
and the time token runs backwards, (T - t)/T, the eval direction of
``aline_tpu`` (training counts up).

With ``seq_mesh`` the candidate pool is split over the ranks of its
``seq`` axis, under every attention core.  Under the role mask
(``ops/roles.py``) every row attends only to the context keys and, for a
query row, the selected targets and the time token; a context or target
row attends only to the context.  So each rank builds its own sequence,
[time? | the Ck context tokens, gathered by ``ctx_idx`` | its block of
the pool | the targets], and computes on it exactly the rows that the
unsharded forward computes for these tokens: the compact core (``auto``,
``compact``) over the gathered keys in slot order, as the unsharded
compact path reads them; the flash kernels and the dense bias (``flash``,
``naive``) from the local roles, the copies in token-index order, the
order in which the unsharded flash plan walks the context keys.  One row
kind reads beyond the rank: a row that sees no key (a batch row with no
context yet) averages over the whole global sequence, so under flash and
naive ``_blind_hook`` replaces its attention output from the pool's
sums (flash) or its gathered keys (naive), at such steps only.
The pool's x and y are small (B x n_pool x a few floats): every rank
keeps them whole.  Beyond that only the design head crosses ranks: the
log-softmax over the global pool (``all_reduce_lse``: an all-reduce MAX,
then an all-reduce SUM of the rescaled exponentials) and the greedy
argmax (the global max, then the smallest global index among the ranks
that hold it, ``torch.argmax``'s first-index rule).  ``select_design``
then runs alike on every rank.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from aline_tpu_torch.ops.attention import CompactKeys, dense_bias_attention
from aline_tpu_torch.ops.flash_attention import padded_len
from aline_tpu_torch.ops.roles import NEG_INF, build_roles
from aline_tpu_torch.parallel.collectives import (all_reduce, all_reduce_lse,
                                                   lse_init, lse_update)
from aline_tpu_torch.parallel.mesh import Mesh, pool_bounds
from aline_tpu_torch.tasks.base import Batch, init_ctx_idx, select_design
from aline_tpu_torch.train.rollout import rollout
from aline_tpu_torch.utils.metrics import span


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
    with span("bed.traces"):
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


def _context_order(batch: Batch, valid: torch.Tensor,
                   impl: str) -> torch.Tensor:
    """[B, Ck] the context slots in the order each rank lays out its copies.
    The compact core keeps slot order (acquisition order), as the
    unsharded compact path does.  The flash plan walks context keys in
    token-index order, so under flash and naive the valid slots are
    sorted by index, the invalid ones after them: each rank then walks the
    keys that the unsharded kernel walks, in its order."""
    if impl in ("auto", "compact"):
        return batch.ctx_idx
    key = torch.where(valid, batch.ctx_idx, batch.n_points)
    order = torch.sort(key, dim=1, stable=True).indices
    return torch.gather(batch.ctx_idx, 1, order)


def _blind_hook(impl: str, roles, t_off: int, Ck: int, nb: int,
                n_pool: int, group):
    """The encoder's ``attn_hook`` for the rows that see no key, or None
    where every row sees one.  Such a row (a batch row with no context:
    its target rows and time row, and its pool rows when no target is
    selected and no time token leads) averages over every column of the
    GLOBAL sequence [time? | pool | targets], not over the rank's.

    * flash: the kernel's rule, ``sum(v) / Np`` over the global padded
      length; the pool's part of the sum is one all-reduce of [B, H, dh].
    * naive: ``softmax(s - 1e9)``, in which the rounding of each
      ``s - 1e9`` weighs a column, so the pool's keys themselves are
      needed: its K and V blocks are gathered from the ranks and the dense
      core runs the blind rows against the global sequence.

    The gathered context copies are left out: in such a batch row none is
    valid, and the pool block holds exactly the rank's pool tokens."""
    sees_ctx = roles.k_is_ctx.any(dim=1)
    sees_extra = (roles.k_is_sel | roles.k_is_time[None]).any(dim=1)
    blind = ~sees_ctx[:, None] & ~(roles.q_is_query & sees_extra[:, None])
    if not bool(blind.any()):
        return None
    N = blind.shape[1]
    pool = slice(t_off + Ck, t_off + Ck + nb)
    dev = blind.device
    rest = torch.cat([torch.arange(t_off, device=dev),
                      torch.arange(pool.stop, N, device=dev)])
    n_global = N - Ck - nb + n_pool
    rows = blind[:, None, :, None]

    def flash(q, k, v, out):
        vf = v.float()
        total = (all_reduce(vf[:, :, pool].sum(dim=2), group=group)
                 + vf[:, :, rest].sum(dim=2))
        mean = (total / padded_len(n_global)).to(out.dtype)
        return torch.where(rows, mean[:, :, None], out)

    def naive(q, k, v, out):
        def glob(t):
            blocks = [t[:, :, pool].contiguous()]
            if group is not None:
                blocks = [torch.empty_like(blocks[0])
                          for _ in range(n_pool // nb)]
                dist.all_gather(blocks, t[:, :, pool].contiguous(),
                                group=group)
            return torch.cat([t[:, :, :t_off], *blocks, t[:, :, pool.stop:]],
                             dim=2)
        which = torch.nonzero(blind.any(dim=0))[:, 0]
        neg = torch.full((1, 1, 1, 1), NEG_INF, dtype=q.dtype,
                         device=q.device)
        o = dense_bias_attention(q[:, :, which], glob(k), glob(v), neg)
        return out.index_copy(2, which, torch.where(rows[:, :, which], o,
                                                    out[:, :, which]))

    return flash if impl == "flash" else naive


def _local_scores(model, batch: Batch, lo: int, hi: int, n_pool: int,
                  group) -> torch.Tensor:
    """The design scores [B, hi - lo] of pool tokens ``lo .. hi - 1``,
    from the sequence [time? | context | pool block | targets]."""
    B, Ck = batch.batch_size, batch.ctx_capacity
    enc = model.encoder
    count = batch.ctx_mask.sum(dim=1)
    slots = torch.arange(Ck, device=count.device)
    valid = slots[None] < count[:, None]
    ctx_idx = _context_order(batch, valid, enc.impl)

    def gather(v):
        return torch.gather(v, 1, ctx_idx[..., None].expand(-1, -1,
                                                             v.shape[-1]))

    # the block's context points stay query-flagged here: no key reads
    # them (the keys are the gathered copies) and the head masks them;
    # an invalid copy is a query-flagged token that no row reads either
    local = batch.replace(
        x=torch.cat([gather(batch.x), batch.x[:, lo:hi]], dim=1),
        y=torch.cat([gather(batch.y), batch.y[:, lo:hi]], dim=1),
        ctx_mask=torch.cat([valid, torch.zeros(B, hi - lo, dtype=torch.bool,
                                               device=valid.device)], dim=1),
        ctx_idx=slots[None].expand(B, Ck))
    t_off = int(enc.with_time_token)
    tokens = model.embedder(local)
    roles = build_roles(local.ctx_mask, tokens.shape[1] - local.n_points,
                        local.target_mask, enc.with_time_token)
    if enc.impl in ("auto", "compact"):
        compact = CompactKeys(local.ctx_idx + t_off, valid, local.n_points,
                              None, t_off)
        z = enc(tokens, roles, local.t, compact=compact)
    else:
        # the flash plan or the dense bias of the local roles
        z = enc(tokens, roles, local.t, attn_hook=_blind_hook(
            enc.impl, roles, t_off, Ck, hi - lo, n_pool, group))
    z_pool = z[:, t_off + Ck:t_off + Ck + hi - lo]
    return model.head.acquisition_head(z_pool, local.t)


def sharded_greedy_rollout(model, batch: Batch, T: int, time_token: bool,
                           mesh: Mesh, axis_name: str = "seq"):
    """T greedy steps with the pool split over ``mesh``'s ``axis_name``
    axis → (idx [T, B], xs [T, B, dim_x], ys [T, B, dim_y], log_probs
    [T, B]), as ``rollout`` gives them greedily, under the model's
    attention core; the time token runs in the eval direction.  ``batch``
    needs its ``ctx_idx`` buffer."""
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
        scores = _local_scores(model, batch, lo, hi, n_pool, group)
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
