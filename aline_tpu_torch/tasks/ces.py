"""Constant-elasticity-of-substitution (CES) utility experiment, a BED
task (``aline_tpu/tasks/ces.py``).

theta = (rho ~ U(0.01, 1), alpha ~ Dirichlet(1, 1, 1), log u ~ N(1, 3));
a design is a pair of 3-commodity baskets in [0, 100]^6; the response is
a censored sigmoid-normal of the scaled utility difference.  The
likelihood broadcasts over a leading contrastive axis, for the sPCE/sNMC
bounds (``eval/eig.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from aline_tpu_torch.distributions.censored_sigmoid_normal import (
    CensoredSigmoidNormal,
)
from aline_tpu_torch.tasks.base import Batch, Task


class CESTask(Task):
    BASKET_DIM = 3

    def __init__(self, cfg):
        super().__init__(cfg)
        self.n_theta = cfg.n_target_theta  # 5: [rho, alpha1..3, log u]
        self.noise_scale = cfg.noise_scale
        self.epsilon = cfg.epsilon
        self.tail_mode = cfg.tail_mode

    # -- priors ------------------------------------------------------------
    def sample_theta(self, gen: torch.Generator,
                     shape: Tuple[int, ...]) -> torch.Tensor:
        """[*shape, 5] parameters.  alpha ~ Dirichlet(1, 1, 1) as three
        Exponential(1) draws over their sum, exact at concentration 1
        (``torch.distributions.Dirichlet`` takes no generator)."""
        shape = tuple(shape)
        dev = gen.device
        rho = 0.01 + 0.99 * torch.rand(shape, generator=gen, device=dev)
        e = torch.empty(shape + (self.BASKET_DIM,), device=dev)
        e.exponential_(1.0, generator=gen)
        alpha = e / e.sum(dim=-1, keepdim=True)
        log_u = 1.0 + 3.0 * torch.randn(shape, generator=gen, device=dev)
        return torch.cat([rho[..., None], alpha, log_u[..., None]], dim=-1)

    def sample_data(self, gen: torch.Generator, batch_size: int,
                    n_data: int) -> torch.Tensor:
        """[B, N, 6] basket pairs, uniform in [0, design_scale]^6."""
        u = torch.rand(batch_size, n_data, 2 * self.BASKET_DIM,
                       generator=gen, device=gen.device)
        return u * self.design_scale

    # the design space is the raw basket space
    def normalise_design(self, x):
        return x

    def unnormalise_design(self, x):
        return x

    # -- model -------------------------------------------------------------
    @staticmethod
    def utility(x, rho, alpha):
        """(sum_i alpha_i x_i^rho)^(1/rho); x [..., 3], rho [..., 1],
        alpha [..., 3].  With rho down to 0.01 the outer power multiplies
        the relative error of the sum by up to 100."""
        weighted = torch.sum(alpha * x ** rho, dim=-1, keepdim=True)
        return weighted ** (1.0 / rho)

    def _response_params(self, xi, theta):
        """(mu_eta, sigma_eta), trailing dim 1, of the latent response for
        designs xi [..., 6] and theta [..., 5] (broadcasting)."""
        rho = theta[..., 0:1]
        alpha = theta[..., 1:4]
        u = torch.exp(theta[..., 4:5])
        xi = torch.clamp(xi, 0.01, 100.0)
        b1 = xi[..., :self.BASKET_DIM]
        b2 = xi[..., self.BASKET_DIM:]
        udiff = (self.utility(b1, rho, alpha)
                 - self.utility(b2, rho, alpha))
        mu_eta = udiff * u
        d = b1 - b2
        dist = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
        sigma_eta = (1.0 + dist) * self.noise_scale * u
        return mu_eta, sigma_eta

    def _response(self, xi, theta) -> CensoredSigmoidNormal:
        mu, sigma = self._response_params(xi, theta)
        return CensoredSigmoidNormal(mu, sigma, self.epsilon,
                                     1.0 - self.epsilon,
                                     tail_mode=self.tail_mode)

    def simulate(self, gen: torch.Generator, xi: torch.Tensor,
                 theta: torch.Tensor) -> torch.Tensor:
        """Preference rating in (0, 1), censored at [eps, 1 - eps]."""
        return self._response(xi, theta).rsample(gen)

    def log_likelihood(self, y, xi, theta):
        """y [..., 1], xi [..., 6], theta [..., 5] (broadcasting, e.g. y
        [1, B, Th, 1], xi [1, B, Th, 6], theta [Lc, B, 1, 5])."""
        return self._response(xi, theta).log_prob(y)

    # -- batch -------------------------------------------------------------
    def sample_batch(self, gen: torch.Generator, batch_size: int,
                     n_query: Optional[int] = None) -> Batch:
        """theta, the candidate basket pairs and y drawn once for every
        candidate; theta packed as 5 tokens."""
        n_query = self.n_query_init if n_query is None else n_query
        theta = self.sample_theta(gen, (batch_size,))        # [B, 5]
        n_points = self.n_context_init + n_query
        x = self.sample_data(gen, batch_size, n_points)
        y = self.simulate(gen, x, theta[:, None, :])          # [B, N, 1]
        target_x = torch.zeros(batch_size, 0, self.dim_x, dtype=x.dtype,
                               device=x.device)
        target_y = torch.zeros(batch_size, 0, 1, dtype=y.dtype,
                               device=y.device)
        return self._pack_batch(x, y, target_x, target_y, theta[..., None],
                                theta)
