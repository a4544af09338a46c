"""Baseline design policies: random, grid and the DAD network
(``aline_tpu/models/baselines.py``)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from aline_tpu_torch.distributions.gmm import normal_log_prob
from aline_tpu_torch.models.init import init_dense_


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


class EncoderNetwork(nn.Module):
    """DAD's history encoder: one (design, outcome) pair → an encoding."""

    def __init__(self, dim_in: int, hidden_dim: int, encoding_dim: int,
                 device=None):
        super().__init__()
        self.linear1 = nn.Linear(dim_in, hidden_dim, device=device)
        self.output_layer = nn.Linear(hidden_dim, encoding_dim,
                                      device=device)

    def forward(self, xi, y):
        h = torch.relu(self.linear1(torch.cat([xi, y], dim=-1)))
        return self.output_layer(h)


class EmitterNetwork(nn.Module):
    """DAD's design emitter."""

    def __init__(self, encoding_dim: int, design_dim: int, device=None):
        super().__init__()
        self.linear = nn.Linear(encoding_dim, design_dim, device=device)

    def forward(self, r):
        return self.linear(r)


class SetEquivariantDesignNetwork(nn.Module):
    """DAD (Foster et al. 2021): the history's encodings, summed over the
    valid steps, emit the next design.  The history is passed whole with a
    step-validity mask, so every step has the same shapes.
    ``empty_value`` is part of the flax parameter tree (and unused)."""

    def __init__(self, dim_x: int, dim_y: int, hidden_dim: int = 128,
                 encoding_dim: int = 16, device=None):
        super().__init__()
        self.dim_x, self.dim_y = dim_x, dim_y
        self.encoder = EncoderNetwork(dim_x + dim_y, hidden_dim,
                                      encoding_dim, device)
        self.emitter = EmitterNetwork(encoding_dim, dim_x, device)
        self.empty_value = nn.Parameter(torch.zeros(dim_x, device=device))
        init_dense_(self)

    def forward(self, xi_hist: torch.Tensor, y_hist: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        """xi_hist [M, T, D], y_hist [M, T, 1], valid [M, T] bool → the
        next design [M, D] (normalised)."""
        enc = self.encoder(xi_hist, y_hist)                  # [M, T, E]
        pooled = torch.sum(enc * valid[..., None].to(enc.dtype), dim=1)
        return self.emitter(pooled)


def draw_trace(task, gen: torch.Generator, T: int, M: int):
    """The draws of one DAD trace: (theta [M, ...], simulator noise [T, M,
    dim_y], exploration noise [T, M, dim_x]), standard normal noises."""
    theta = task.sample_theta(gen, (M,))
    sim = torch.randn(T, M, task.dim_y, generator=gen, device=gen.device)
    explore = torch.randn(T, M, task.dim_x, generator=gen,
                          device=gen.device)
    return theta, sim, explore


def run_trace(model: SetEquivariantDesignNetwork, task, theta, sim_noise,
              explore_noise: Optional[torch.Tensor] = None,
              explore_std: float = 0.0):
    """Roll out M parallel DAD experiments of T = ``sim_noise.shape[0]``
    steps: propose a design, simulate it (``task.simulate_from_noise``),
    append it to the history.  ``explore_std`` adds explore_std ·
    ``explore_noise`` to each emitted design (reparameterised), which
    pathwise sPCE training uses to leave the constant-trajectory start.

    Returns (theta, designs in the real space [M, T, D], outcomes [M, T,
    1]).  The histories are rebuilt out of place at each step, so the
    gradient flows through every design into the later ones."""
    T, M = sim_noise.shape[0], sim_noise.shape[1]
    dev = sim_noise.device
    xi_hist = torch.zeros(M, T, model.dim_x, device=dev)
    y_hist = torch.zeros(M, T, model.dim_y, device=dev)
    steps = torch.arange(T, device=dev)
    for t in range(T):
        here = (steps == t)[None, :, None]
        xi = model(xi_hist, y_hist, (steps < t)[None].expand(M, T))
        if explore_std:
            xi = xi + explore_std * explore_noise[t]
        y = task.simulate_from_noise(task.unnormalise_design(xi), theta,
                                     sim_noise[t])
        xi_hist = torch.where(here, xi[:, None], xi_hist)
        y_hist = torch.where(here, y[:, None], y_hist)
    return theta, task.to_design_space(xi_hist), y_hist
