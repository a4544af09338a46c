"""Token role flags for the ALINE attention pattern
(``aline_tpu/ops/roles.py``).

    allowed[b, i, j] =  k_is_ctx[b, j]
                     | (q_is_query[b, i] & k_is_sel[b, j])
                     | (q_is_query[b, i] & k_is_time[j])        (time token)

Every row attends to the context columns; query rows also attend to the
selected target columns and the optional global time token; targets
attend only context.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e9  # large-negative instead of -inf: keeps softmax NaN-free


class Roles(NamedTuple):
    """Per-token role flags over the packed sequence
    [time? | points | target_data | theta]."""
    q_is_query: torch.Tensor   # [B, N] row may attend targets/time
    k_is_ctx: torch.Tensor     # [B, N] column visible to everyone
    k_is_sel: torch.Tensor     # [B, N] column is a selected target
    k_is_time: torch.Tensor    # [N]    column is the global time token


def build_roles(ctx_mask: torch.Tensor, n_target: int,
                target_mask: torch.Tensor,
                with_time_token: bool = False) -> Roles:
    """Role flags for a batch.

    Args:
        ctx_mask:    [B, n_points] bool current context flags.
        n_target:    number of target tokens (target_data + theta).
        target_mask: [n_target] bool selected targets.
        with_time_token: a global time-token slot leads the sequence.
    """
    B, n_points = ctx_mask.shape
    n_time = int(with_time_token)
    dev = ctx_mask.device
    no_time = torch.zeros(B, n_time, dtype=torch.bool, device=dev)
    no_target = torch.zeros(B, n_target, dtype=torch.bool, device=dev)
    k_is_time = torch.zeros(n_time + n_points + n_target, dtype=torch.bool,
                            device=dev)
    k_is_time[:n_time] = True
    return Roles(
        q_is_query=torch.cat([no_time, ~ctx_mask, no_target], dim=1),
        k_is_ctx=torch.cat([no_time, ctx_mask, no_target], dim=1),
        k_is_sel=torch.cat([no_time, torch.zeros_like(ctx_mask),
                            target_mask[None].expand(B, n_target)], dim=1),
        k_is_time=k_is_time)


def attention_bias(roles: Roles, dtype=torch.float32) -> torch.Tensor:
    """Materialized additive bias [B, 1, N, N] (naive / small-N path)."""
    allowed = (roles.k_is_ctx[:, None, :]
               | (roles.q_is_query[:, :, None]
                  & (roles.k_is_sel | roles.k_is_time[None])[:, None, :]))
    zero = torch.zeros((), dtype=dtype, device=allowed.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=allowed.device)
    return torch.where(allowed, zero, neg)[:, None]


def roles_to_codes(roles: Roles):
    """The flash kernel's (kcode, qrow) int32 vectors [B, N]
    (``aline_tpu/ops/flash_attention.py`` ``roles_to_codes``):
    kcode 0 = invisible, 1 = context (visible to every row), 2 = visible
    to query rows (selected target or time token); qrow 1 = query row."""
    ctx = roles.k_is_ctx.to(torch.int32)
    extra = (roles.k_is_sel | roles.k_is_time[None]).to(torch.int32)
    kcode = ctx + 2 * extra * (~roles.k_is_ctx).to(torch.int32)
    return kcode, roles.q_is_query.to(torch.int32)
