"""Streaming sPCE / sNMC expected-information-gain bounds
(``aline_tpu/eval/eig.py``, its single-device path).

Bound definitions:
    sPCE = log(L+1) - [logsumexp_{l=0..L} S_l - S_0]
    sNMC = log(L)   - [logsumexp_{l=1..L} S_l - S_0]
where S_l is the cumulative trajectory log-likelihood under theta_l and
theta_0 is the data-generating latent.  The L contrastive draws are
processed in chunks of Lc, each folded into a running max-shifted
logsumexp (``parallel/collectives.py``), so the memory taken is that of
one chunk whatever L is; theta_0 is folded in exactly at the end by
``logaddexp``.

Chunk i draws its thetas from a generator seeded by ``derive_seed(seed,
i)`` alone, so at a fixed chunk size the bounds do not depend on how the
chunks are grouped into calls (``L_checkpoints``), bit for bit.  The
draws cannot match JAX's; ``thetas=`` computes the bounds on given draws.
The chunk loop never waits for the host: the padding of the last chunk
and every guard of the fold are tensor operations, and the chunk count
is known before the loop.

Not ported: the ``mesh`` and ``seq_mesh`` arguments, which shard the
chunks and the query pool across devices.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from aline_tpu_torch.eval.traces import get_traces
from aline_tpu_torch.parallel.collectives import (
    LogSumExpState,
    lse_init,
    lse_update,
    lse_value,
)

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit generator seed from ``seed`` and the integers ``path``
    (SplitMix64 over each in turn): streams keyed by different paths are
    independent, as JAX's ``fold_in`` makes them."""
    z = _splitmix64(seed & _MASK64)
    for p in path:
        z = _splitmix64(z ^ (p & _MASK64))
    return z >> 1


# Bytes of one float32 [Lc, B, Th] block of the chunk fold.  At its peak
# the fold holds about 2·K·D + 2 such blocks at once for location finding
# (the [Lc, B, Th, K, D] differences and their squares, then the
# log-likelihood and the shifted exponentials), so 256 MiB a block keeps
# a K=1, D=2 fold near 1.5 GiB of device memory, and each of its eager
# passes still runs over tens of millions of elements.  CES holds about
# eight blocks (the [Lc, B, Th, 3] basket powers and the censored
# density's terms): one chunk at its BED shape (Lc=32768 at the L_chunk
# cap, B=100, Th=16: 200 MiB blocks) took 1.624 GiB above the traces on
# an H100 (chip_smoke.py phase 10b), so the rule fits both tasks.
CHUNK_BLOCK_BYTES = 256 * 2**20


def chunk_size(L: int, B: int, Th: int, L_chunk: int) -> int:
    """Lc: the contrastive draws of one chunk, at most ``L_chunk`` and
    at most what keeps a float32 [Lc, B, Th] block within
    ``CHUNK_BLOCK_BYTES``."""
    cap = max(1, CHUNK_BLOCK_BYTES // (4 * max(B * Th, 1)))
    return int(min(L_chunk, cap, max(L, 1)))


def _seq_cum_loglik(task, x, y, thetas) -> torch.Tensor:
    """S [Lc, B, Th] with S[l, b, t] = sum_{s<=t} log p(y_s | x_s, th_l),
    for designs x [B, Th, D] (real space), outcomes y [B, Th, 1] and
    thetas [Lc, B, ...]."""
    ll = task.log_likelihood(y[None], x[None], thetas.unsqueeze(2))
    return torch.cumsum(ll[..., 0], dim=-1)


def _fold(state: LogSumExpState, task, x, y, thetas,
          n_valid: int) -> LogSumExpState:
    """Fold one chunk of thetas whose first ``n_valid`` rows count (the
    rest, the padding past L, are set to -inf)."""
    S = _seq_cum_loglik(task, x, y, thetas)
    if n_valid < S.shape[0]:
        S[max(n_valid, 0):] = -torch.inf
    return lse_update(state, S, axis=0)


def accumulate_chunks(task, x, y, seed: int, L: int, Lc: int, i0: int,
                      n_chunks: int, state: LogSumExpState
                      ) -> LogSumExpState:
    """Fold chunks ``i0 .. i0 + n_chunks - 1`` of Lc draws into ``state``;
    chunk i's thetas come from ``derive_seed(seed, i)`` alone."""
    gen = torch.Generator(device=x.device)
    B = x.shape[0]
    for i in range(i0, i0 + n_chunks):
        gen.manual_seed(derive_seed(seed, i))
        state = _fold(state, task, x, y, task.sample_theta(gen, (Lc, B)),
                      L - i * Lc)
    return state


def _as_f32(name, t) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, not {t.dtype}: the "
                        f"bounds are computed in float32")
    return t


def compute_eig_from_history(task, theta_0, x, y, L: int, seed: int,
                             L_chunk: int = 32_768, stepwise: bool = False,
                             thetas: Optional[torch.Tensor] = None,
                             L_checkpoints: Optional[list] = None):
    """sPCE/sNMC bounds for a batch of histories.

    Args:
        theta_0: [B, ...] data-generating latents.
        x: [B, Th, D] UNNORMALISED design history; y: [B, Th, 1]
            outcomes; float32, on the device the bounds are computed on.
        L: number of contrastive samples, drawn from ``seed``.
        stepwise: return [B, Th] per-step bounds instead of [B].
        thetas: optional pre-drawn contrastive latents [L, B, ...]: the
            bounds on exactly these draws (``L`` and ``seed`` unused), in
            chunks of the same size.
        L_checkpoints: optional intermediate L values: the accumulator is
            read as the fold passes each (snapped up to a chunk multiple),
            so one pass gives the bounds at every one.

    Returns:
        (pce, nmc), [B, Th] if stepwise else [B]; with ``L_checkpoints``
        a ``{L_eff: (pce, nmc)}`` dict keyed by the snapped L.
    """
    x, y, theta_0 = (_as_f32(n, t) for n, t in
                     (("x", x), ("y", y), ("theta_0", theta_0)))
    B, Th = x.shape[0], x.shape[1]
    ll0 = task.log_likelihood(y, x, theta_0.unsqueeze(1))
    S0 = torch.cumsum(ll0[..., 0], dim=-1)                   # [B, Th]
    state = lse_init((B, Th), device=x.device)

    if thetas is not None:
        thetas = _as_f32("thetas", thetas)
        L = int(thetas.shape[0])
        Lc = chunk_size(L, B, Th, L_chunk)

        def fold_chunks(state, i0, n):
            for i in range(i0, i0 + n):
                state = _fold(state, task, x, y,
                              thetas[i * Lc:(i + 1) * Lc], Lc)
            return state
    else:
        Lc = chunk_size(L, B, Th, L_chunk)

        def fold_chunks(state, i0, n):
            return accumulate_chunks(task, x, y, seed, L, Lc, i0, n, state)

    n_chunks = math.ceil(L / Lc)
    marks = sorted({min(math.ceil(lc / Lc), n_chunks)
                    for lc in L_checkpoints or ()} | {n_chunks})
    results, done = {}, 0
    for mark in marks:
        state = fold_chunks(state, done, mark - done)
        done = mark
        L_eff = min(mark * Lc, L)
        results[L_eff] = _finalize_bounds(state, S0, L_eff, stepwise)
    return results if L_checkpoints else results[L]


def _finalize_bounds(state: LogSumExpState, S0, L: int, stepwise: bool):
    lse_contrastive = lse_value(state)                       # l = 1..L
    lse_all = torch.logaddexp(lse_contrastive, S0)           # l = 0..L
    # log(L+1) and log(L) rounded to float32, as JAX takes them; a Python
    # number, so no host value is copied to the device
    pce = float(np.log(np.float32(L + 1))) - (lse_all - S0)
    nmc = float(np.log(np.float32(L))) - (lse_contrastive - S0)
    if not stepwise:
        pce, nmc = pce[:, -1], nmc[:, -1]
    return pce, nmc


def aggregate_bounds(pce_list, nmc_list,
                     err_type: str) -> Dict[str, np.ndarray]:
    """Mean and error over the outer M axis: ``se`` (standard error),
    ``ci`` (1.96 standard errors) or ``std``."""
    pce = np.concatenate(pce_list, axis=0)                   # [M(, Th)]
    nmc = np.concatenate(nmc_list, axis=0)
    M_eff = pce.shape[0]
    pce_mean, pce_err = pce.mean(0), pce.std(0)
    nmc_mean, nmc_err = nmc.mean(0), nmc.std(0)
    if err_type == "se":
        pce_err, nmc_err = (pce_err / np.sqrt(M_eff),
                            nmc_err / np.sqrt(M_eff))
    elif err_type == "ci":
        pce_err, nmc_err = (1.96 * pce_err / np.sqrt(M_eff),
                            1.96 * nmc_err / np.sqrt(M_eff))
    elif err_type != "std":
        raise ValueError(f"unknown err_type {err_type!r}")
    return dict(pce_mean=pce_mean, pce_err=pce_err,
                nmc_mean=nmc_mean, nmc_err=nmc_err)


def eval_eig_from_history(task, theta_0, x, y, L: int, seed: int,
                          M: Optional[int] = None, batch_size: int = 40,
                          stepwise: bool = False, err_type: str = "se",
                          L_chunk: int = 32_768) -> Dict[str, np.ndarray]:
    """Bounds of PRE-COMPUTED histories (baseline policies' traces),
    mini-batched over the outer M axis; batch j's draws come from
    ``derive_seed(seed, j)``."""
    M = x.shape[0] if M is None else min(M, x.shape[0])
    pce_list, nmc_list = [], []
    for j, start in enumerate(range(0, M, batch_size)):
        end = min(start + batch_size, M)
        pce, nmc = compute_eig_from_history(
            task, theta_0[start:end], x[start:end], y[start:end], L,
            derive_seed(seed, j), L_chunk=L_chunk, stepwise=stepwise)
        pce_list.append(pce.cpu().numpy())
        nmc_list.append(nmc.cpu().numpy())
    return aggregate_bounds(pce_list, nmc_list, err_type)


def eval_boed(model, task, T: int, L: int, M: int, batch_size: int,
              seed: int, time_token: bool = False, stepwise: bool = False,
              err_type: str = "se", L_chunk: int = 32_768,
              n_query: Optional[int] = None,
              logger=None) -> Dict[str, np.ndarray]:
    """The BED evaluation: ceil(M / batch_size) batches, each drawn on
    the model's device, rolled out greedily for T steps
    (``get_traces``), then bounded (``compute_eig_from_history``); mean
    and error over all rows.  Batch s draws from ``derive_seed(seed, 0,
    s)`` and its contrastive thetas from ``derive_seed(seed, 1, s)``."""
    device = next(model.parameters()).device
    pce_list, nmc_list = [], []
    for step in range((M + batch_size - 1) // batch_size):
        gen = torch.Generator(device=device).manual_seed(
            derive_seed(seed, 0, step))
        batch = task.sample_batch(gen, batch_size, n_query=n_query)
        theta_0, x, y = get_traces(model, task, batch, T, time_token)
        pce, nmc = compute_eig_from_history(
            task, theta_0, x, y, L, derive_seed(seed, 1, step),
            L_chunk=L_chunk, stepwise=stepwise)
        pce_list.append(pce.cpu().numpy())
        nmc_list.append(nmc.cpu().numpy())
        if logger is not None:
            logger.info(f"Step {step}: PCE {pce_list[-1].mean(0)}, "
                        f"NMC {nmc_list[-1].mean(0)}")
    return aggregate_bounds(pce_list, nmc_list, err_type)
