"""Streaming logsumexp (``aline_tpu/parallel/collectives.py``, its
single-device part).

The sPCE/sNMC bounds need ``logsumexp`` over up to L = 1e7 contrastive
samples.  L is processed in chunks, folded into a running (max,
sum of shifted exponentials) pair; two pairs combine associatively.
Every guard is a tensor operation, so a fold never waits for the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
