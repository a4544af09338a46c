"""The benchmark's inputs, drawn on the device from a seed.

Each batch is drawn by a ``torch.Generator`` on the device seeded with
``derive_seed(seed, unit, ...)``, so any batch of a run can be drawn
again for the check, and the same seed gives the same inputs.  The
draws follow each task's generative model as the configuration states
it: a GP prior with a random kernel for active learning, hidden sources
under noise for location finding.  They import nothing of the program.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.eig import derive_seed


def generator(device, seed: int, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        derive_seed(seed, *path))


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       device=gen.device)


def gp_batch(gen: torch.Generator, B: int, n_query: int, task: dict):
    """A GP active-learning batch: ``x`` [B, n_ctx + n_query, dx], ``y``,
    ``target_x`` [B, Td, dx], ``target_y`` [B, Td, 1] and ``theta``
    [B, dx + 1, 1] (lengthscales, output scale).  The kernel of each row
    is RBF, Matern-1/2, -3/2 or -5/2 with the configured weights; the
    outcomes are a draw of the GP at all points, with Gaussian noise."""
    dx = task["dim_x"]
    base = math.sqrt(dx)
    ls = _uniform(gen, (B, dx), task["lengthscale_lower"] * base,
                  task["lengthscale_upper"] * base)
    iso = torch.rand(B, generator=gen, device=gen.device) < task["p_iso"]
    ls = torch.where(iso[:, None], ls[:, :1], ls)
    scale = _uniform(gen, (B,), 0.1, 1.0)
    n_pts = task["n_context_init"] + n_query
    N = n_pts + task["n_target_data"]
    s = task["design_scale"]
    x = _uniform(gen, (B, N, dx), -s, s)
    w = torch.tensor(task["kernel_weights"] or [1 / 3, 0.0, 1 / 3, 1 / 3],
                     device=gen.device)
    kind = torch.multinomial(w.expand(B, -1), 1, generator=gen)[:, 0]
    eps_f = torch.randn(B, N, 1, generator=gen, device=gen.device)
    eps_n = torch.randn(B, N, 1, generator=gen, device=gen.device)
    d = (x[:, :, None, :] - x[:, None, :, :]) / ls[:, None, None, :]
    sq = (d * d).sum(-1)
    r = torch.sqrt(sq.clamp(min=0.0))
    sc = scale[:, None, None]
    k = kind[:, None, None]
    K = torch.where(k == 0, sc * torch.exp(-0.5 * sq),
                    torch.where(k == 1, sc * torch.exp(-r),
                                torch.where(k == 2, sc * (1 + math.sqrt(3) * r)
                                            * torch.exp(-math.sqrt(3) * r),
                                            sc * (1 + math.sqrt(5) * r
                                                  + 5.0 / 3.0 * sq)
                                            * torch.exp(-math.sqrt(5) * r))))
    del d, sq, r
    eye = torch.eye(N, device=x.device)
    L, info = torch.linalg.cholesky_ex(K + 1e-5 * eye)
    bad = info != 0
    if bool(bad.any()):
        L2, info2 = torch.linalg.cholesky_ex(K[bad] + 1e-3 * eye)
        if bool((info2 != 0).any()):
            raise RuntimeError("GP covariance not positive definite")
        L[bad] = L2
    y = L @ eps_f + task["noise_scale"] * eps_n
    theta = torch.cat([ls, scale[:, None]], dim=-1)[..., None]
    return dict(x=x[:, :n_pts], y=y[:, :n_pts], target_x=x[:, n_pts:],
                target_y=y[:, n_pts:], theta=theta)


def loc_batch(gen: torch.Generator, B: int, n_query: int, task: dict):
    """A location-finding batch: K sources ``theta`` [B, K, D] uniform on
    the unit box, candidate designs ``x`` [B, n_ctx + n_query, D] in it
    and the noisy signal ``y`` [B, N, 1] at every candidate."""
    if task["theta_dist"] != "uniform":
        raise NotImplementedError("only the uniform prior is drawn here")
    K, D = task["K"], task["dim_x"]
    theta = torch.rand((B, K, D), generator=gen, device=gen.device)
    N = task["n_context_init"] + n_query
    x = torch.rand((B, N, D), generator=gen, device=gen.device)
    diff = x[:, :, None, :] - theta[:, None]
    sig = torch.log(task["base_signal"] + (
        1.0 / (task["max_signal"] + (diff * diff).sum(-1))).sum(
            -1, keepdim=True))
    y = sig + task["noise_scale"] * torch.randn(
        sig.shape, generator=gen, device=gen.device)
    return dict(x=x, y=y, theta=theta)


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws from uniforms of ``gen``."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
