"""Gaussian-process prior sampler for amortized active learning
(``aline_tpu/tasks/gp.py``).

The whole batch is one batched covariance build and one batched Cholesky.
The per-element kernel type is handled by computing all four kernels from
one distance matrix and selecting one.  The random draws
(``GPTask.sample_batch``, ``generate_gp_data``) are kept apart from the
arithmetic (``gp_outcomes``), so the tests feed both packages the same
draws.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from aline_tpu_torch.ops.sobol import (
    permute_points,
    random_permutations,
    sample_sobol,
)
from aline_tpu_torch.tasks.base import Batch, Task

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def scaled_sq_dists(x1, x2, lengthscales):
    """[..., N, D], [..., M, D], [..., D] → [..., N, M]."""
    d = ((x1[..., :, None, :] - x2[..., None, :, :])
         / lengthscales[..., None, None, :])
    return torch.sum(d * d, dim=-1)


def kernel_stack(sq_dist, scale):
    """(rbf, matern12, matern32, matern52) from one distance matrix
    → [4, ..., N, M]."""
    r = torch.sqrt(torch.clamp(sq_dist, min=0.0))
    s = scale[..., None, None]
    rbf = s * torch.exp(-0.5 * sq_dist)
    m12 = s * torch.exp(-r)
    m32 = s * (1.0 + _SQRT3 * r) * torch.exp(-_SQRT3 * r)
    m52 = (s * (1.0 + _SQRT5 * r + (5.0 / 3.0) * sq_dist)
           * torch.exp(-_SQRT5 * r))
    return torch.stack([rbf, m12, m32, m52], dim=0)


def cholesky_with_retry(K: torch.Tensor, jitter: float) -> torch.Tensor:
    """Cholesky of ``K + jitter·I`` [B, N, N]; rows that fail are redone
    at 100× the jitter.

    ``torch.linalg.cholesky_ex`` reports failure in ``info`` (and leaves a
    partial factor), where ``jnp.linalg.cholesky`` returns NaN; a row that
    fails both times is set to NaN, as the JAX package's retry leaves it.
    """
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    L, info = torch.linalg.cholesky_ex(K + jitter * eye)
    bad = info != 0
    if bad.any():
        L_retry, info_retry = torch.linalg.cholesky_ex(
            K[bad] + (100.0 * jitter) * eye)
        L_retry[info_retry != 0] = float("nan")
        L[bad] = L_retry
    return L


class GPTask(Task):
    """GP active-learning simulator.

    theta = [per-dim lengthscales (isotropic with prob p_iso), output
    scale], stored as [B, dim_x + 1, 1].
    """

    def __init__(self, cfg):
        super().__init__(cfg)
        self.jitter = 1e-5
        self.p_iso = cfg.p_iso
        self.kernel_weights = (cfg.kernel_weights
                               if cfg.kernel_weights is not None
                               else [1.0 / 3.0, 0.0, 1.0 / 3.0, 1.0 / 3.0])
        self.noise_scale = cfg.noise_scale
        self.data_gen = getattr(cfg, "data_gen", "uniform")
        if self.data_gen not in ("uniform", "sobol", "lattice"):
            raise ValueError(f"unknown data_gen {self.data_gen!r}")
        if (self.embedding_type in ("mix", "theta")
                and cfg.n_target_theta != self.dim_x + 1):
            raise ValueError("n_target_theta must equal dim_x + 1 for "
                             "theta/mix embedding")
        # lengthscale prior bounds scale with sqrt(dim_x)
        base = math.sqrt(self.dim_x)
        self.lengthscale_lower = cfg.lengthscale_lower * base
        self.lengthscale_upper = cfg.lengthscale_upper * base
        self.scale_lower, self.scale_upper = 0.1, 1.0

    # -- priors ------------------------------------------------------------
    def _uniform(self, gen, shape, low, high):
        u = torch.rand(shape, generator=gen, device=gen.device)
        return low + (high - low) * u

    def sample_theta(self, gen: torch.Generator,
                     shape: Tuple[int, ...]) -> torch.Tensor:
        """[*shape, dim_x+1, 1] hyperparameters."""
        shape = tuple(shape)
        ls = self._uniform(gen, shape + (self.dim_x,),
                           self.lengthscale_lower, self.lengthscale_upper)
        is_iso = torch.rand(shape, generator=gen, device=gen.device) \
            < self.p_iso
        ls = torch.where(is_iso[..., None], ls[..., :1], ls)
        scale = self._uniform(gen, shape, self.scale_lower, self.scale_upper)
        return torch.cat([ls, scale[..., None]], dim=-1)[..., None]

    def sample_data(self, gen: torch.Generator, batch_size: int,
                    n_data: int) -> torch.Tensor:
        """Uniform designs in [-design_scale, design_scale]^dim_x."""
        return self._uniform(gen, (batch_size, n_data, self.dim_x),
                             -self.design_scale, self.design_scale)

    def _to_box(self, pts):
        """Points of [0, 1)^D onto [-design_scale, design_scale]^D."""
        return pts * 2.0 * self.design_scale - self.design_scale

    def sample_data_sobol(self, gen: torch.Generator, batch_size: int,
                          n_data: int) -> torch.Tensor:
        """Scrambled Sobol designs (``ops/sobol.py``) in the box."""
        return self._to_box(sample_sobol(gen, batch_size, n_data,
                                         self.dim_x))

    def lattice_alphas(self) -> torch.Tensor:
        """The R_d Kronecker sequence's generator vector: powers of 1/g,
        g^(D+1) = g + 1 (the generalised golden ratio), in float32."""
        g = 1.0
        for _ in range(64):
            g = (1.0 + g) ** (1.0 / (self.dim_x + 1))
        return torch.tensor([((1.0 / g) ** (d + 1)) % 1.0
                             for d in range(self.dim_x)],
                            dtype=torch.float32)

    def lattice_points(self, n_data: int, shift: torch.Tensor,
                       perms: torch.Tensor) -> torch.Tensor:
        """Rank-1 lattice designs in the box: i·alpha mod 1, shifted by
        ``shift`` [B, 1, D] mod 1, each dimension reordered by ``perms``
        [B, D, n_data]."""
        i = torch.arange(n_data, dtype=torch.float32,
                         device=shift.device)[:, None]
        base = torch.remainder(
            i * self.lattice_alphas().to(shift.device)[None, :], 1.0)
        pts = torch.remainder(base[None] + shift, 1.0)
        return self._to_box(permute_points(pts, perms))

    def sample_data_lattice(self, gen: torch.Generator, batch_size: int,
                            n_data: int) -> torch.Tensor:
        """Randomised rank-1 lattice designs: a uniform shift and the
        permutations drawn from ``gen``."""
        shift = torch.rand(batch_size, 1, self.dim_x, generator=gen,
                           device=gen.device)
        return self.lattice_points(
            n_data, shift,
            random_permutations(gen, batch_size, self.dim_x, n_data))

    # -- GP sampling -------------------------------------------------------
    def _covariance(self, x, theta, kernel_idx):
        """x [B, N, D], theta [B, D+1, 1], kernel_idx [B] → K [B, N, N]."""
        ls = theta[:, :self.dim_x, 0]
        scale = theta[:, self.dim_x, 0]
        ks = kernel_stack(scaled_sq_dists(x, x, ls), scale)   # [4, B, N, N]
        b = torch.arange(x.shape[0], device=x.device)
        return ks[kernel_idx, b]

    def gp_outcomes(self, x, theta, kernel_idx, eps_f, eps_noise):
        """Noisy GP outcomes [B, N, 1] from given standard-normal draws
        ``eps_f`` and ``eps_noise`` (both [B, N, 1])."""
        L = cholesky_with_retry(self._covariance(x, theta, kernel_idx),
                                self.jitter)
        return L @ eps_f + self.noise_scale * eps_noise

    def generate_gp_data(self, gen: torch.Generator, x, theta):
        """Draw the kernel type and the normals, then ``gp_outcomes``."""
        B, N, _ = x.shape
        w = torch.tensor(self.kernel_weights, dtype=torch.float32,
                         device=gen.device)
        kernel_idx = torch.multinomial(w.expand(B, -1), 1, generator=gen)[:, 0]
        eps_f = torch.randn(B, N, 1, generator=gen, device=gen.device)
        eps_noise = torch.randn(B, N, 1, generator=gen, device=gen.device)
        return self.gp_outcomes(x, theta, kernel_idx, eps_f, eps_noise)

    def sample_batch(self, gen: torch.Generator, batch_size: int,
                     n_query: Optional[int] = None) -> Batch:
        """Joint GP draw over context ∪ query ∪ target points, on the
        generator's device."""
        n_query = self.n_query_init if n_query is None else n_query
        theta = self.sample_theta(gen, (batch_size,))
        n_points = self.n_context_init + n_query
        sample = {"uniform": self.sample_data,
                  "sobol": self.sample_data_sobol,
                  "lattice": self.sample_data_lattice}[self.data_gen]
        x_all = sample(gen, batch_size, n_points + self.n_target_data)
        y_all = self.generate_gp_data(gen, x_all, theta)
        return self._pack_batch(x_all[:, :n_points], y_all[:, :n_points],
                                x_all[:, n_points:], y_all[:, n_points:],
                                theta, theta)
