"""Streaming and sharded logsumexp (``aline_tpu/parallel/collectives.py``).

The sPCE/sNMC bounds need ``logsumexp`` over up to L = 1e7 contrastive
samples.  L is processed in chunks, folded into a running (max,
sum of shifted exponentials) pair; two pairs combine associatively, on
one device or across the ranks of a process group (an all-reduce MAX of
the maxima, then an all-reduce SUM of the rescaled sums).  Every guard is
a tensor operation, so neither a fold nor a combine waits for the host.
A ``group`` of None (one rank) skips the collectives.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class LogSumExpState(NamedTuple):
    """Running logsumexp accumulator: logsumexp = max + log(sumexp)."""
    max: torch.Tensor      # running maximum
    sumexp: torch.Tensor   # sum of exp(x - max)


def lse_init(shape, dtype=torch.float32, device=None) -> LogSumExpState:
    return LogSumExpState(
        torch.full(shape, -torch.inf, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device))


def _rescale(state: LogSumExpState, safe: torch.Tensor) -> torch.Tensor:
    """``state.sumexp * exp(state.max - safe)``, 0 where the state is
    still empty (max = -inf), never exp(-inf - -inf) = NaN."""
    shift = torch.where(torch.isfinite(state.max), state.max - safe,
                        -torch.inf)
    return state.sumexp * torch.exp(shift)


def _safe(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, 0.0)


def lse_update(state: LogSumExpState, chunk: torch.Tensor,
               axis: int = 0) -> LogSumExpState:
    """Fold a chunk (reduced over ``axis``) into the accumulator; entries
    of -inf (padding) add nothing."""
    new_max = torch.maximum(state.max, torch.amax(chunk, dim=axis))
    safe = _safe(new_max)
    scaled_chunk = torch.sum(torch.exp(chunk - safe.unsqueeze(axis)),
                             dim=axis)
    return LogSumExpState(new_max, _rescale(state, safe) + scaled_chunk)


def lse_value(state: LogSumExpState) -> torch.Tensor:
    return state.max + torch.log(state.sumexp)


def streaming_logsumexp_combine(state_a: LogSumExpState,
                                state_b: LogSumExpState) -> LogSumExpState:
    """Associative combine of two accumulators."""
    new_max = torch.maximum(state_a.max, state_b.max)
    safe = _safe(new_max)
    return LogSumExpState(new_max, _rescale(state_a, safe)
                          + _rescale(state_b, safe))


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """``t`` reduced with ``op`` over ``group`` (a new tensor; ``t`` is
    left as it was); ``t`` itself when ``group`` is None."""
    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_lse(state: LogSumExpState, group=None) -> LogSumExpState:
    """The combine of every rank's accumulator over ``group``: the global
    max, then the sum of each rank's sum rescaled to it.  A rank that
    folded nothing (max = -inf) adds 0."""
    if group is None:
        return state
    gmax = all_reduce(state.max, dist.ReduceOp.MAX, group)
    total = all_reduce(_rescale(state, _safe(gmax)), dist.ReduceOp.SUM, group)
    return LogSumExpState(gmax, total)


def sharded_logsumexp(x: torch.Tensor, group=None) -> torch.Tensor:
    """logsumexp over the local leading axis AND the ranks of ``group``:
    each rank folds its block, then ``all_reduce_lse`` combines them."""
    state = lse_init(x.shape[1:], x.dtype, x.device)
    return lse_value(all_reduce_lse(lse_update(state, x), group))
