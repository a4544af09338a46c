"""sPCE / sNMC bounds of location finding, written from their
definitions:

    sPCE = log(L+1) - [logsumexp_{l=0..L} S_l - S_0]
    sNMC = log(L)   - [logsumexp_{l=1..L} S_l - S_0]

with S_l[b, t] the log-likelihood of the first t+1 outcomes of row b
under theta_l (theta_0 the latent that generated them), and the
observation model y = log(base + sum_k 1 / (max_signal + |xi -
theta_k|^2)) + noise * eps.

The L contrastive draws are the program's by its stated rule: chunk i of
Lc draws [Lc, B, K, D] comes from a ``torch.Generator`` on the device
seeded with ``derive_seed(seed, i)`` (SplitMix64), uniform on the unit
box, with Lc the largest chunk whose float32 [Lc, B, Th] block fits in
256 MiB, at most ``L_chunk``.  The reference draws them again from that
rule; it takes nothing the program computed.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.model import LOG_2PI, Rounder

_MASK64 = (1 << 64) - 1
BLOCK_BYTES = 256 * 2**20


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit seed from ``seed`` and the integers ``path``."""
    z = _splitmix64(seed & _MASK64)
    for p in path:
        z = _splitmix64(z ^ (p & _MASK64))
    return z >> 1


def chunk_size(L: int, B: int, Th: int, L_chunk: int) -> int:
    return int(min(L_chunk, max(1, BLOCK_BYTES // (4 * max(B * Th, 1))),
                   max(L, 1)))


def loc_loglik(y, xi, theta, task: dict, r: Rounder):
    """log p(y | xi, theta): y [..., Th, 1], xi [..., Th, D], theta
    [..., 1, K, D] broadcast → [..., Th]; ``r`` rounds every result."""
    diff = r(xi[..., None, :] - theta)                    # [..., Th, K, D]
    sq = r((diff * diff).sum(-1))
    inv = r(1.0 / r(task["max_signal"] + sq))
    mu = r(torch.log(r(task["base_signal"] + inv.sum(-1))))
    z = r((y[..., 0] - mu) / task["noise_scale"])
    return r(-0.5 * (z * z + LOG_2PI) - math.log(task["noise_scale"]))


@torch.no_grad()
def loc_bounds(theta0, x, y, L: int, seed: int, L_chunk: int, task: dict,
               r: Rounder, B_draw: int = None, rows=None):
    """(pce, nmc) [b, Th] of designs x [b, Th, D] (real space), outcomes
    y [b, Th, 1] and latents theta0 [b, K, D]: rows ``rows`` of a batch
    of ``B_draw`` rows (default: the whole batch), whose draws are made
    for the whole batch."""
    if task["theta_dist"] != "uniform":
        raise NotImplementedError("only the uniform prior is drawn here")
    b, Th = x.shape[:2]
    B = B_draw or b
    K, D = task["K"], x.shape[-1]
    S0 = r(torch.cumsum(loc_loglik(y, x, theta0[:, None], task, r), -1))
    Lc = chunk_size(L, B, Th, L_chunk)
    gen = torch.Generator(device=x.device)
    acc = torch.full((b, Th), -torch.inf, device=x.device)
    for i in range(math.ceil(L / Lc)):
        gen.manual_seed(derive_seed(seed, i))
        th = torch.rand((Lc, B, K, D), generator=gen, device=x.device)
        th = th[:max(0, min(Lc, L - i * Lc))]
        if rows is not None:
            th = th[:, rows]
        S = r(torch.cumsum(loc_loglik(y[None], x[None], th[:, :, None],
                                      task, r), -1))
        acc = torch.logaddexp(acc, r(torch.logsumexp(S, dim=0)))
    pce = math.log(L + 1) - (torch.logaddexp(acc, S0) - S0)
    nmc = math.log(L) - (acc - S0)
    return pce, nmc
