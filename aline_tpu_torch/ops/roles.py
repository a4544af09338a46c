"""Token role flags for the ALINE attention pattern
(``aline_tpu/ops/roles.py``, without the time token, which is not ported).

    allowed[b, i, j] = k_is_ctx[b, j] | (q_is_query[b, i] & k_is_sel[b, j])

Every row attends to the context columns; query rows also attend to the
selected target columns; targets attend only context.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e9  # large-negative instead of -inf: keeps softmax NaN-free


class Roles(NamedTuple):
    """Per-token role flags over the packed sequence
    [points | target_data | theta]."""
    q_is_query: torch.Tensor   # [B, N] row may attend targets
    k_is_ctx: torch.Tensor     # [B, N] column visible to everyone
    k_is_sel: torch.Tensor     # [B, N] column is a selected target


def build_roles(ctx_mask: torch.Tensor, n_target: int,
                target_mask: torch.Tensor) -> Roles:
    """Role flags for a batch.

    Args:
        ctx_mask:    [B, n_points] bool current context flags.
        n_target:    number of target tokens (target_data + theta).
        target_mask: [n_target] bool selected targets.
    """
    B, n_points = ctx_mask.shape
    no_target = torch.zeros(B, n_target, dtype=torch.bool,
                            device=ctx_mask.device)
    return Roles(
        q_is_query=torch.cat([~ctx_mask, no_target], dim=1),
        k_is_ctx=torch.cat([ctx_mask, no_target], dim=1),
        k_is_sel=torch.cat([torch.zeros_like(ctx_mask),
                            target_mask[None].expand(B, n_target)], dim=1))


def attention_bias(roles: Roles, dtype=torch.float32) -> torch.Tensor:
    """Materialized additive bias [B, 1, N, N] (naive / small-N path)."""
    allowed = (roles.k_is_ctx[:, None, :]
               | (roles.q_is_query[:, :, None] & roles.k_is_sel[:, None, :]))
    zero = torch.zeros((), dtype=dtype, device=allowed.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=allowed.device)
    return torch.where(allowed, zero, neg)[:, None]
