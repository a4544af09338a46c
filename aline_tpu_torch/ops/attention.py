"""Attention for the ALINE role mask (``aline_tpu/ops/attention.py``).

* ``dense_bias_attention`` — dense [B,H,N,N] scores with an additive bias;
  ground truth for tests, the ``naive`` path.
* ``compact_attention``   — every row may attend only to the current
  context points (at most ``ctx_capacity`` of them) and, for query rows,
  the selected targets and the time token.  Keys and values are gathered
  into that compact set, so the score matrix is [N, Ck + n_target(+1)]
  instead of [N, N].  Exact:
  a column outside the set is masked for every row, and ``exp(-1e9 - m)``
  is 0 in float32.

Scores and softmax run in float32.  With bfloat16 q, k and v (the model's
compute dtype) each einsum runs in bfloat16, summed in float32 and rounded
once, as XLA's bfloat16 einsum does: the scores are rounded before the
float32 softmax, the weights are cast to bfloat16 before the product with
v.  On the card ``resolve_device`` keeps cuBLAS from reducing bfloat16
products in reduced precision.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from aline_tpu_torch.ops.roles import NEG_INF, Roles


class CompactKeys(NamedTuple):
    """Gather plan over the packed sequence [time? | points | targets]."""
    ctx_idx: torch.Tensor    # [B, Ck] int64 indices of context tokens
    ctx_valid: torch.Tensor  # [B, Ck] bool
    n_points: int
    # Static target-block indices that may be attended this step (the
    # True set of the target mask); None keeps every target column.
    ext_idx: Optional[Tuple[int, ...]] = None
    time_offset: int = 0     # 1 when a global time token leads the sequence


def context_indices(ctx_mask: torch.Tensor, capacity: int,
                    time_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token indices of the context points in index order, padded to
    ``capacity``."""
    order = torch.argsort((~ctx_mask).to(torch.int8), dim=1, stable=True)
    idx = order[:, :capacity] + time_offset
    count = ctx_mask.sum(dim=1)
    valid = (torch.arange(capacity, device=ctx_mask.device)[None]
             < count[:, None])
    return idx, valid


def take_static(a: torch.Tensor, idx: Tuple[int, ...],
                dim: int) -> torch.Tensor:
    """``a`` at the static indices ``idx`` (ascending) along ``dim``, as
    slices of their runs of consecutive indices: no index tensor is made
    from the host's list, a copy that a CUDA graph cannot capture.  One
    run (every mask the entry points use) is a view."""
    runs = []
    for i in idx:
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    parts = [a.narrow(dim, lo, hi - lo) for lo, hi in runs or [[0, 0]]]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def dense_bias_attention(q, k, v, bias):
    """q/k/v: [B, H, N, dh]; bias: [B, 1, N, N]."""
    dh = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / math.sqrt(dh)
    attn = torch.softmax(scores + bias.float(), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", attn.to(q.dtype), v)


def compact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      roles: Roles, compact: CompactKeys) -> torch.Tensor:
    """Exact ALINE-masked attention over the compact key set.

    q/k/v: [B, H, N, dh] over the full sequence → [B, H, N, dh].
    """
    B, H, N, dh = q.shape
    t_off = compact.time_offset
    tgt_start = t_off + compact.n_points

    # Context keys by index; slots past the live count point at some
    # token, and the bias below masks them.
    gidx = compact.ctx_idx[:, None, :, None].expand(B, H, -1, dh)
    k_ctx = torch.gather(k, 2, gidx)                          # [B,H,Ck,dh]
    v_ctx = torch.gather(v, 2, gidx)
    k_ext = k[:, :, tgt_start:]
    v_ext = v[:, :, tgt_start:]
    ext_cols = roles.k_is_sel[:, tgt_start:]                  # [B, Nt]
    if compact.ext_idx is not None:
        k_ext, v_ext, ext_cols = (
            take_static(a, compact.ext_idx, dim)
            for a, dim in ((k_ext, 2), (v_ext, 2), (ext_cols, 1)))
    if t_off:                         # the time column leads the extra keys
        k_ext = torch.cat([k[:, :, :1], k_ext], dim=2)
        v_ext = torch.cat([v[:, :, :1], v_ext], dim=2)
        ext_cols = torch.cat([torch.ones_like(ext_cols[:, :1]), ext_cols],
                             dim=1)
    K = torch.cat([k_ctx, k_ext], dim=2)                      # [B,H,Nk,dh]
    V = torch.cat([v_ctx, v_ext], dim=2)

    zero = torch.zeros((), device=q.device)
    neg = torch.full((), NEG_INF, device=q.device)
    ctx_bias = torch.where(compact.ctx_valid, zero, neg)      # [B, Ck]
    ext_bias = torch.where(
        roles.q_is_query[:, :, None] & ext_cols[:, None, :], zero, neg)
    bias = torch.cat([ctx_bias[:, None, :].expand(B, N, -1), ext_bias],
                     dim=-1)[:, None]                         # [B,1,N,Nk]

    scores = torch.einsum("bhqd,bhkd->bhqk", q, K).float() / math.sqrt(dh)
    attn = torch.softmax(scores + bias, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", attn.to(q.dtype), V)
