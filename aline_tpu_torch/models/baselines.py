"""Baseline design policies: random and grid
(``aline_tpu/models/baselines.py``).  DAD's design network is not ported
yet."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from aline_tpu_torch.distributions.gmm import normal_log_prob


def _linspace01(n: int) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit as XLA computes it: i times
    the float32 reciprocal of n - 1, then the end point 1 exactly."""
    if n == 1:
        return torch.zeros(1)
    step = torch.tensor(1.0 / (n - 1), dtype=torch.float32)
    return torch.cat([torch.arange(n - 1, dtype=torch.float32) * step,
                      torch.ones(1)])


class RandomDesign:
    """Random design policy: uniform in [low, high] or normal."""

    def __init__(self, dim_x: int, random_type: str = "uniform",
                 low: float = 0.0, high: float = 1.0,
                 loc: float = 0.0, scale: float = 1.0):
        if random_type not in ("uniform", "normal"):
            raise ValueError(
                f"Random design type {random_type!r} is not supported!")
        self.dim_x = dim_x
        self.random_type = random_type
        self.low, self.high = low, high
        self.loc, self.scale = loc, scale

    def design_candidates(self, gen: torch.Generator, batch_size: int = 1,
                          T: int = 30) -> torch.Tensor:
        """[B, T, D] random designs, on the generator's device."""
        shape = (batch_size, T, self.dim_x)
        if self.random_type == "uniform":
            u = torch.rand(shape, generator=gen, device=gen.device)
            return self.low + (self.high - self.low) * u
        return self.loc + self.scale * torch.randn(shape, generator=gen,
                                                   device=gen.device)

    def log_prob(self, xi: torch.Tensor) -> torch.Tensor:
        """[B] log-density of designs xi [B, D]."""
        if self.random_type == "uniform":
            lp = torch.full(xi.shape, -math.log(self.high - self.low),
                            device=xi.device)
        else:
            lp = normal_log_prob(xi, self.loc, self.scale)
        return lp.sum(-1)

    def __call__(self, gen: torch.Generator, batch_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One design per batch element and its log-prob."""
        xi = self.design_candidates(gen, batch_size, 1)[:, 0]
        return xi, self.log_prob(xi)


class GridDesign:
    """Grid design policy: the meshgrid of ``num_points`` per axis."""

    def __init__(self, dim_x: int, design_scales=None):
        if design_scales is not None and len(design_scales) != dim_x:
            raise ValueError(
                f"The length of design scales {len(design_scales)} "
                f"conflicts with the design dimension {dim_x}!")
        self.dim_x = dim_x
        self.design_scales = design_scales
        self.xi_designs: Optional[torch.Tensor] = None

    def design_candidates(self, batch_size: int = 1,
                          num_points: int = 30) -> torch.Tensor:
        """[B, num_points**D, D] meshgrid designs."""
        scales = (self.design_scales if self.design_scales is not None
                  else [1.0] * self.dim_x)
        axes = [_linspace01(num_points) * s for s in scales]
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        grid = grid.reshape(-1, self.dim_x)
        self.xi_designs = grid[None]
        return grid[None].expand((batch_size,) + grid.shape)

    def __call__(self, t: int, batch_size: int) -> torch.Tensor:
        """The t-th grid design for every batch element."""
        return self.xi_designs[:, t].expand(batch_size, self.dim_x)
