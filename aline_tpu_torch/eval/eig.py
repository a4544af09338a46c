"""Streaming, mesh-sharded sPCE / sNMC expected-information-gain bounds
(``aline_tpu/eval/eig.py``).

Bound definitions:
    sPCE = log(L+1) - [logsumexp_{l=0..L} S_l - S_0]
    sNMC = log(L)   - [logsumexp_{l=1..L} S_l - S_0]
where S_l is the cumulative trajectory log-likelihood under theta_l and
theta_0 is the data-generating latent.  The L contrastive draws are
processed in chunks of Lc, each folded into a running max-shifted
logsumexp (``parallel/collectives.py``), so the memory taken is that of
one chunk whatever L is; theta_0 is folded in exactly at the end by
``logaddexp``.

Chunk i draws its thetas [Lc, B] from a generator seeded by
``derive_seed(seed, i)`` alone, so at a fixed chunk size the bounds do not
depend on how the chunks are grouped into calls (``L_checkpoints``), bit
for bit.  The draws cannot match JAX's; ``thetas=`` computes the bounds on
given draws.  The chunk loop never waits for the host: the padding of the
last chunk and every guard of the fold are tensor operations, and the
chunk count is known before the loop.

``mesh`` shards the work over ranks (``parallel/mesh.py``): the chunk ids
over the ``contrastive`` axis in contiguous blocks (a rank past the last
chunk folds nothing), the batch rows over the ``data`` axis.  One draw
rule holds for every mesh: chunk i still draws [Lc, B] for the GLOBAL
batch from ``derive_seed(seed, i)``, a contrastive rank folds only its
chunks and a data rank keeps only its rows of each draw.  So the
single-process, the 1-D and the 2-D bounds use the same draws and differ
only in the order of the fold, a stronger rule than JAX's, whose 2-D
draws are keyed per (chunk, global row) and differ from its 1-D ones.
The chunk size is computed from the global batch: from the local one the
chunk boundaries, and so the draws, would move.  ``seq_mesh`` shards the
greedy rollout's candidate pool (``eval/traces.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from aline_tpu_torch.eval.traces import get_traces
from aline_tpu_torch.parallel.collectives import (
    LogSumExpState,
    all_reduce,
    all_reduce_lse,
    lse_init,
    lse_value,
)
from aline_tpu_torch.parallel.mesh import Mesh, replicate
from aline_tpu_torch.utils.metrics import count, span

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


# Bytes of one float32 [Lc, B, Th] block of the chunk fold.  The plain
# fold of location finding (the CPU's) holds about 2·K·D + 2 such blocks
# at once (the [Lc, B, Th, K, D] differences and their squares, then the
# log-likelihood and the shifted exponentials), so 256 MiB a block keeps
# a K=1, D=2 fold near 1.5 GiB of memory.  Its kernel on the card holds
# none, but the rule stays: Lc decides which thetas chunk i draws, so it
# is part of the bounds' definition (and of the benchmark's reference,
# which draws them again by this rule).  CES's plain fold holds about
# eight blocks (the [Lc, B, Th, 3] basket powers and the censored
# density's terms): one chunk at its BED shape (Lc=32768 at the L_chunk
# cap, B=100, Th=16: 200 MiB blocks) took 1.624 GiB above the traces on
# an H100 before its kernel (chip_smoke.py phase 10b), so the rule fits
# both tasks; its kernel holds none either.
CHUNK_BLOCK_BYTES = 256 * 2**20


def chunk_size(L: int, B: int, Th: int, L_chunk: int) -> int:
    """Lc: the contrastive draws of one chunk, at most ``L_chunk`` and
    at most what keeps a float32 [Lc, B, Th] block within
    ``CHUNK_BLOCK_BYTES``."""
    cap = max(1, CHUNK_BLOCK_BYTES // (4 * max(B * Th, 1)))
    return int(min(L_chunk, cap, max(L, 1)))


def _fold(state: LogSumExpState, task, x, y, thetas,
          n_valid: int) -> LogSumExpState:
    """Fold one chunk of thetas whose first ``n_valid`` rows count (the
    rest, the padding past L, add nothing) by the task's
    ``fold_eig_chunk``: its fold kernel where its likelihood has one
    (``ops/eig_fold_kernel.py``: one launch a chunk on the card), else the
    generic fold (spans ``eig.loglik`` and ``eig.lse``).  Each chunk counts
    the (draw, row, step) terms it folds, ``eig.terms``."""
    with span("eig.chunk"):
        count("eig.terms", max(0, min(n_valid, thetas.shape[0]))
              * x.shape[0] * x.shape[1])
        return task.fold_eig_chunk(state, x.contiguous(),
                                   y[..., 0].contiguous(),
                                   thetas.contiguous(), n_valid)


def accumulate_chunks(task, x, y, seed: int, L: int, Lc: int, i0: int,
                      n_chunks: int, state: LogSumExpState,
                      rows: slice = slice(None), B: Optional[int] = None
                      ) -> LogSumExpState:
    """Fold chunks ``i0 .. i0 + n_chunks - 1`` of Lc draws into ``state``;
    chunk i's thetas [Lc, B] come from ``derive_seed(seed, i)`` alone, of
    which ``rows`` (the rows of ``x`` within the batch of ``B``, default
    all of it) are folded."""
    gen = torch.Generator(device=x.device)
    B = x.shape[0] if B is None else B
    for i in range(i0, i0 + n_chunks):
        gen.manual_seed(derive_seed(seed, i))
        state = _fold(state, task, x, y,
                      task.sample_theta(gen, (Lc, B))[:, rows], L - i * Lc)
    return state


def _as_f32(name, t) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, not {t.dtype}: the "
                        f"bounds are computed in float32")
    return t


def compute_eig_from_history(task, theta_0, x, y, L: int, seed: int,
                             L_chunk: int = 32_768, stepwise: bool = False,
                             thetas: Optional[torch.Tensor] = None,
                             L_checkpoints: Optional[list] = None,
                             mesh: Optional[Mesh] = None,
                             axis_name: str = "contrastive"):
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
            so one pass gives the bounds at every one.  Without a mesh.
        mesh: optional mesh whose ``axis_name`` axis shards the chunks and
            whose ``data`` axis (if any) shards the rows (module
            docstring).  Every rank of the mesh calls with the same
            arguments and gets the bounds of the whole batch.

    Returns:
        (pce, nmc), [B, Th] if stepwise else [B]; with ``L_checkpoints``
        a ``{L_eff: (pce, nmc)}`` dict keyed by the snapped L.
    """
    with span("eig.fold"):
        x, y, theta_0 = (_as_f32(n, t) for n, t in
                         (("x", x), ("y", y), ("theta_0", theta_0)))
        B, Th = x.shape[0], x.shape[1]
        if thetas is not None:
            thetas = _as_f32("thetas", thetas)
            L = int(thetas.shape[0])
        # the chunk size of the GLOBAL batch: the draws depend on it
        Lc = chunk_size(L, B, Th, L_chunk)
        n_chunks = math.ceil(L / Lc)
        if mesh is not None:
            if L_checkpoints:
                raise ValueError("L_checkpoints is computed without a mesh")
            return _sharded_bounds(task, theta_0, x, y, L, seed, Lc, n_chunks,
                                   stepwise, thetas, mesh, axis_name)
        ll0 = task.log_likelihood(y, x, theta_0.unsqueeze(1))
        S0 = torch.cumsum(ll0[..., 0], dim=-1)                   # [B, Th]
        state = lse_init((B, Th), device=x.device)

        def fold_chunks(state, i0, n):
            return _fold_ids(state, task, x, y, range(i0, i0 + n), L, Lc, seed,
                             thetas, slice(None), B)

        marks = sorted({min(math.ceil(lc / Lc), n_chunks)
                        for lc in L_checkpoints or ()} | {n_chunks})
        results, done = {}, 0
        for mark in marks:
            state = fold_chunks(state, done, mark - done)
            done = mark
            L_eff = min(mark * Lc, L)
            results[L_eff] = _finalize_bounds(state, S0, L_eff, stepwise)
        return results if L_checkpoints else results[L]


def _fold_ids(state, task, x, y, ids: range, L: int, Lc: int, seed: int,
              thetas: Optional[torch.Tensor], rows: slice, B: int):
    """Fold the chunks ``ids`` (a contiguous range), keeping ``rows`` of
    each chunk's [Lc, B] draws; from ``thetas`` where given."""
    if thetas is None:
        return accumulate_chunks(task, x, y, seed, L, Lc, ids.start,
                                 len(ids), state, rows, B)
    for i in ids:
        state = _fold(state, task, x, y, thetas[i * Lc:(i + 1) * Lc, rows],
                      Lc)
    return state


def _sharded_bounds(task, theta_0, x, y, L: int, seed: int, Lc: int,
                    n_chunks: int, stepwise: bool, thetas, mesh: Mesh,
                    axis_name: str):
    """The bounds on ``mesh``: this rank folds its block of the chunk ids
    on its rows, the contrastive axis combines the accumulators, and the
    data axis puts the rows' bounds together."""
    B = x.shape[0]
    n_data = mesh.axis_size("data")
    if B % n_data:
        raise ValueError(f"batch {B} must divide mesh data axis {n_data}")
    B_loc = B // n_data
    d = mesh.index("data")
    rows = slice(d * B_loc, (d + 1) * B_loc)
    per = math.ceil(n_chunks / mesh.axis_size(axis_name))
    c = mesh.index(axis_name)
    ids = range(min(c * per, n_chunks), min((c + 1) * per, n_chunks))
    x_l, y_l = x[rows], y[rows]
    ll0 = task.log_likelihood(y_l, x_l, theta_0[rows].unsqueeze(1))
    S0 = torch.cumsum(ll0[..., 0], dim=-1)                   # [B_loc, Th]
    state = _fold_ids(lse_init((B_loc, x.shape[1]), device=x.device), task,
                      x_l, y_l, ids, L, Lc, seed, thetas, rows, B)
    state = all_reduce_lse(state, mesh.group(axis_name))
    bounds = _finalize_bounds(state, S0, L, stepwise)
    if n_data == 1:
        return bounds
    # each row's bounds from its data rank: a sum over the data axis of
    # the rows placed in zeros, exact (x + 0 = x)
    out = []
    for t in bounds:
        full = torch.zeros((B,) + t.shape[1:], dtype=t.dtype,
                           device=t.device)
        full[rows] = t
        out.append(all_reduce(full, group=mesh.group("data")))
    return tuple(out)


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
                          L_chunk: int = 32_768,
                          mesh: Optional[Mesh] = None
                          ) -> Dict[str, np.ndarray]:
    """Bounds of PRE-COMPUTED histories (baseline policies' traces),
    mini-batched over the outer M axis; batch j's draws come from
    ``derive_seed(seed, j)``.  ``mesh`` as for
    ``compute_eig_from_history``."""
    M = x.shape[0] if M is None else min(M, x.shape[0])
    pce_list, nmc_list = [], []
    for j, start in enumerate(range(0, M, batch_size)):
        end = min(start + batch_size, M)
        pce, nmc = compute_eig_from_history(
            task, theta_0[start:end], x[start:end], y[start:end], L,
            derive_seed(seed, j), L_chunk=L_chunk, stepwise=stepwise,
            mesh=mesh)
        pce_list.append(pce.cpu().numpy())
        nmc_list.append(nmc.cpu().numpy())
    return aggregate_bounds(pce_list, nmc_list, err_type)


def eval_boed(model, task, T: int, L: int, M: int, batch_size: int,
              seed: int, time_token: bool = False, stepwise: bool = False,
              err_type: str = "se", L_chunk: int = 32_768,
              n_query: Optional[int] = None,
              mesh: Optional[Mesh] = None, seq_mesh: Optional[Mesh] = None,
              logger=None) -> Dict[str, np.ndarray]:
    """The BED evaluation: ceil(M / batch_size) batches, each drawn on
    the model's device, rolled out greedily for T steps
    (``get_traces``), then bounded (``compute_eig_from_history``); mean
    and error over all rows.  Batch s draws from ``derive_seed(seed, 0,
    s)`` and its contrastive thetas from ``derive_seed(seed, 1, s)``.

    ``mesh`` shards the bounds (``compute_eig_from_history``); each rank
    rolls the whole batch out and takes the traces of the mesh's first
    rank.  ``seq_mesh`` shards the rollout's candidate pool over its
    ``seq`` axis (``get_traces``).  Every rank of the meshes calls with the
    same arguments and gets the same result."""
    device = next(model.parameters()).device
    pce_list, nmc_list = [], []
    for step in range((M + batch_size - 1) // batch_size):
        gen = torch.Generator(device=device).manual_seed(
            derive_seed(seed, 0, step))
        batch = task.sample_batch(gen, batch_size, n_query=n_query)
        theta_0, x, y = get_traces(model, task, batch, T, time_token,
                                   seq_mesh=seq_mesh)
        if mesh is not None:
            theta_0, x, y = replicate((theta_0, x, y), mesh)
        pce, nmc = compute_eig_from_history(
            task, theta_0, x, y, L, derive_seed(seed, 1, step),
            L_chunk=L_chunk, stepwise=stepwise, mesh=mesh)
        pce_list.append(pce.cpu().numpy())
        nmc_list.append(nmc.cpu().numpy())
        if logger is not None:
            logger.info(f"Step {step}: PCE {pce_list[-1].mean(0)}, "
                        f"NMC {nmc_list[-1].mean(0)}")
    return aggregate_bounds(pce_list, nmc_list, err_type)
