"""Psychometric-function experiment, 4 parameters, Gumbel link
(``aline_tpu/tasks/psychometric.py``).

theta = (alpha threshold, beta slope, gamma guess rate, lambda lapse
rate), each uniform on its range; ``F(x) = 1 - exp(-10^((x - alpha) /
beta))``; Bernoulli outcomes, the whole batch in one draw.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from aline_tpu_torch.tasks.base import Batch, Task


class PsychometricTask(Task):
    ALPHA_RANGE = (-3.0, 3.0)
    BETA_RANGE = (0.1, 2.0)
    GAMMA_RANGE = (0.1, 0.9)
    LAMBDA_RANGE = (0.0, 0.5)

    # -- priors ------------------------------------------------------------
    def sample_theta(self, gen: torch.Generator,
                     shape: Tuple[int, ...]) -> torch.Tensor:
        """[*shape, 4, 1] parameters."""
        ranges = (self.ALPHA_RANGE, self.BETA_RANGE, self.GAMMA_RANGE,
                  self.LAMBDA_RANGE)
        u = torch.rand(tuple(shape) + (4,), generator=gen, device=gen.device)
        return torch.stack([lo + (hi - lo) * u[..., i]
                            for i, (lo, hi) in enumerate(ranges)],
                           dim=-1)[..., None]

    def sample_data(self, gen: torch.Generator, batch_size: int,
                    n_data: int) -> torch.Tensor:
        """[B, N, dim_x] stimulus intensities, uniform in
        [-design_scale, design_scale]."""
        u = torch.rand(batch_size, n_data, self.dim_x, generator=gen,
                       device=gen.device)
        return -self.design_scale + 2.0 * self.design_scale * u

    # stimulus intensity needs no rescaling
    def to_design_space(self, xi):
        return xi

    def normalise_design(self, x):
        return x

    def unnormalise_design(self, x):
        return x

    # -- model -------------------------------------------------------------
    def psychometric_function(self, x: torch.Tensor,
                              theta: torch.Tensor) -> torch.Tensor:
        """Response probability [..., 1] for stimuli x [..., 1] and theta
        [..., 4, 1] or [..., 4] (broadcasting).  A steep slope sends
        10^z to inf, and then F is 1 exactly."""
        if theta.shape[-1] == 1 and theta.shape[-2] == 4:
            theta = theta[..., 0]
        alpha = theta[..., 0:1]
        beta = theta[..., 1:2]
        gamma = theta[..., 2:3]
        lmbda = theta[..., 3:4]
        z = (x - alpha) / beta
        F = 1.0 - torch.exp(-torch.pow(10.0, z))
        return lmbda * gamma + (1.0 - lmbda) * F

    def simulate(self, gen: torch.Generator, xi: torch.Tensor,
                 theta: torch.Tensor) -> torch.Tensor:
        """Bernoulli responses."""
        p = self.psychometric_function(xi, theta)
        u = torch.rand(p.shape, generator=gen, device=gen.device)
        return (u < p).float()

    def log_likelihood(self, y, xi, theta):
        """The Bernoulli log-likelihood."""
        p = self.psychometric_function(xi, theta)
        return y * torch.log(p + 1e-10) + (1.0 - y) * torch.log(
            1.0 - p + 1e-10)

    # -- batch -------------------------------------------------------------
    def sample_batch(self, gen: torch.Generator, batch_size: int,
                     n_query: Optional[int] = None) -> Batch:
        """theta [B, 4, 1] (also the 4 target tokens), the stimuli and
        one Bernoulli outcome for each."""
        n_query = self.n_query_init if n_query is None else n_query
        theta = self.sample_theta(gen, (batch_size,))        # [B, 4, 1]
        n_points = self.n_context_init + n_query
        x = self.sample_data(gen, batch_size, n_points)      # [B, N, 1]
        y = self.simulate(gen, x, theta[:, None])            # [B, N, 1]
        target_x = torch.zeros(batch_size, 0, self.dim_x, dtype=x.dtype,
                               device=x.device)
        target_y = torch.zeros(batch_size, 0, 1, dtype=y.dtype,
                               device=y.device)
        return self._pack_batch(x, y, target_x, target_y, theta, theta)
