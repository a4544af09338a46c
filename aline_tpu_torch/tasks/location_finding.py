"""Hidden-source location finding, a BED task
(``aline_tpu/tasks/location_finding.py``).

K hidden sources at theta_k in dim_x dimensions; the signal at a design
xi is ``log(base + sum_k 1/(max_signal + ||xi - theta_k||^2))``, observed
with Gaussian noise.  The likelihood broadcasts over a leading
contrastive axis, for the sPCE/sNMC bounds (``eval/eig.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from aline_tpu_torch.distributions.gmm import normal_log_prob
from aline_tpu_torch.ops import eig_fold_kernel
from aline_tpu_torch.tasks.base import Batch, Task


def total_density(xi: torch.Tensor, theta: torch.Tensor, base_signal: float,
                  max_signal: float) -> torch.Tensor:
    """Signal strength: xi [..., D], theta [..., K, D] with broadcastable
    leading dims → [..., 1]."""
    diff = xi[..., None, :] - theta                         # [..., K, D]
    sq = torch.sum(diff * diff, dim=-1)                     # [..., K]
    inv = 1.0 / (max_signal + sq)
    return torch.log(base_signal + torch.sum(inv, dim=-1, keepdim=True))


def log_likelihood(y, xi, theta, base_signal: float, max_signal: float,
                   noise_scale: float) -> torch.Tensor:
    """Gaussian log-likelihood of outcomes y [..., 1] at designs xi
    [..., D] under sources theta [..., K, D], all broadcast (e.g. y
    [1, B, Th, 1], xi [1, B, Th, D], theta [Lc, B, 1, K, D] → [Lc, B, Th,
    1])."""
    return normal_log_prob(
        y, total_density(xi, theta, base_signal, max_signal), noise_scale)


class HiddenLocation(Task):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.K = cfg.K
        self.theta_dist = cfg.theta_dist
        self.noise_scale = cfg.noise_scale
        self.base_signal = cfg.base_signal
        self.max_signal = cfg.max_signal
        self.outcome_scale = cfg.outcome_scale
        if self.theta_dist == "uniform":
            # theta ~ U[0, 1]^{K x D}; designs drawn in the same box
            self.data_low, self.data_high = 0.0, 1.0
        elif self.theta_dist == "normal":
            # theta ~ N(0, I); designs drawn in [-4, 4]^D
            self.data_low, self.data_high = -4.0, 4.0
        else:
            raise ValueError(
                f"prior distribution type {self.theta_dist!r} not supported")
        # both priors have unit scale, the default design_scale
        self.design_scale = float(cfg.design_scale or 1.0)
        if self.n_target_theta != self.K * self.dim_x:
            raise ValueError("n_target_theta must equal K * dim_x")

    # -- priors ------------------------------------------------------------
    def sample_theta(self, gen: torch.Generator,
                     shape: Tuple[int, ...]) -> torch.Tensor:
        """[*shape, K, dim_x] source locations."""
        full = tuple(shape) + (self.K, self.dim_x)
        if self.theta_dist == "uniform":
            return torch.rand(full, generator=gen, device=gen.device)
        return torch.randn(full, generator=gen, device=gen.device)

    def sample_data(self, gen: torch.Generator, batch_size: int,
                    n_data: int) -> torch.Tensor:
        """[B, N, dim_x] candidate designs, uniform in the prior's box."""
        u = torch.rand(batch_size, n_data, self.dim_x, generator=gen,
                       device=gen.device)
        return self.data_low + (self.data_high - self.data_low) * u

    # -- physics -----------------------------------------------------------
    def total_density(self, xi: torch.Tensor,
                      theta: torch.Tensor) -> torch.Tensor:
        """Signal strength (``total_density``) under this task's
        constants."""
        return total_density(xi, theta, self.base_signal, self.max_signal)

    def simulate(self, gen: torch.Generator, xi: torch.Tensor,
                 theta: torch.Tensor) -> torch.Tensor:
        """Noisy signal at designs xi in the REAL design space."""
        signal = self.total_density(xi, theta)
        eps = torch.randn(signal.shape, generator=gen, device=gen.device,
                          dtype=signal.dtype)
        return signal + self.noise_scale * eps

    def simulate_from_noise(self, xi: torch.Tensor, theta: torch.Tensor,
                            eps: torch.Tensor) -> torch.Tensor:
        """``simulate`` on given standard-normal draws ``eps`` of the
        signal's shape: reparameterised, so a gradient flows from the
        outcome into the design."""
        return self.total_density(xi, theta) + self.noise_scale * eps

    def log_likelihood(self, y, xi, theta):
        """Gaussian log-likelihood (``log_likelihood``) under this task's
        constants."""
        return log_likelihood(y, xi, theta, self.base_signal,
                              self.max_signal, self.noise_scale)

    def fold_eig_chunk(self, state, x, y, thetas, n_valid: int):
        """The fold kernel ``loc_eig_fold`` (thetas [Lc, B, K, D]) with
        this task's constants."""
        K, D = self.K, self.dim_x
        return eig_fold_kernel.eig_fold(
            "loc_eig_fold", state, x, y, thetas, n_valid,
            loglik=self.log_likelihood, draw=(K, D), width=D,
            numbers=(K, D, self.base_signal, self.max_signal,
                     self.noise_scale))

    # -- batch -------------------------------------------------------------
    def sample_batch(self, gen: torch.Generator, batch_size: int,
                     n_query: Optional[int] = None) -> Batch:
        """theta, the candidate designs (normalised), and y drawn once for
        every candidate; theta packed as ``n_target_theta`` tokens."""
        n_query = self.n_query_init if n_query is None else n_query
        theta = self.sample_theta(gen, (batch_size,))       # [B, K, D]
        n_points = self.n_context_init + n_query
        x = self.sample_data(gen, batch_size, n_points)
        y = self.simulate(gen, self.unnormalise_design(x),
                          theta[:, None])                   # [B, N, 1]
        theta_tokens = theta.reshape(batch_size, self.n_target_theta, 1)
        target_x = torch.zeros(batch_size, 0, self.dim_x, dtype=x.dtype,
                               device=x.device)
        target_y = torch.zeros(batch_size, 0, 1, dtype=y.dtype,
                               device=y.device)
        return self._pack_batch(x, y, target_x, target_y, theta_tokens,
                                theta)
