"""Analytic benchmark functions for the out-of-distribution evaluation of
active-learning policies (``aline_tpu/tasks/benchmarks.py``).

Ten standard test functions, each on its own domain: a design in the
normalised box [-design_scale, design_scale]^dim is mapped onto the
domain, and observed with Gaussian noise.  Eval-only: no theta and no
likelihood.  The draws (``sample_batch``) are kept apart from the
arithmetic (``observe``, ``batch_from_draws``), so the tests feed both
packages the same draws.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from aline_tpu_torch.tasks.base import Batch, Task

_PI = math.pi
_E = math.e


def _forrester(x):
    """domain [0, 1]"""
    x = x[..., 0]
    return ((6 * x - 2) ** 2 * torch.sin(12 * x - 4)) / 5


def _branin(x):
    """Picheny-rescaled Branin, domain [0, 1]^2"""
    x1p, x2p = 15.0 * x[..., 0], 15.0 * x[..., 1]
    b = 5.1 / (4.0 * _PI ** 2)
    c = 5.0 / _PI
    t = 1.0 / (8.0 * _PI)
    val = (x2p - b * x1p ** 2 + c * x1p - 6.0) ** 2 \
        + 10.0 * (1.0 - t) * torch.cos(x1p) + 10.0
    return (val - 44.81) / 51.95


def _gramacy1d(x):
    """domain [0.5, 2.5]"""
    x = x[..., 0]
    return (torch.sin(10 * _PI * x) / (2 * x) + (x - 1) ** 4) / 3


def _gramacy2d(x):
    """domain [-2, 6]^2"""
    x1, x2 = x[..., 0], x[..., 1]
    return x1 * torch.exp(-x1 ** 2 - x2 ** 2)


def _higdon(x):
    """domain [0, 20], piecewise at x = 10"""
    x = x[..., 0]
    low = torch.sin(_PI * x / 5) + 0.2 * torch.cos(4 * _PI * x / 5)
    high = x / 10 - 1
    return torch.where(x < 10, low, high)


def _rosenbrock(x):
    """domain [-2, 2]^2"""
    x1, x2 = x[..., 0], x[..., 1]
    return 100 * (x2 - x1 ** 2) ** 2 + (x1 - 1) ** 2


def _ackley(x):
    """domain [-2, 2]^2, scaled by 1/5"""
    x1, x2 = x[..., 0], x[..., 1]
    t1 = -20 * torch.exp(-0.2 * torch.sqrt(0.5 * (x1 ** 2 + x2 ** 2)))
    t2 = -torch.exp(0.5 * (torch.cos(2 * _PI * x1)
                           + torch.cos(2 * _PI * x2)))
    return (t1 + t2 + 20 + _E) / 5


def _three_hump_camel(x):
    """domain [-2, 2]^2"""
    x1, x2 = x[..., 0], x[..., 1]
    return 2 * x1 ** 2 - 1.05 * x1 ** 4 + x1 ** 6 / 6 + x1 * x2 + x2 ** 2


def _holder_table(x):
    """domain [-10, 10]^2, scaled by 1/10"""
    x1, x2 = x[..., 0], x[..., 1]
    t1 = torch.sin(x1) * torch.cos(x2)
    t2 = torch.exp(torch.abs(1 - torch.sqrt(x1 ** 2 + x2 ** 2) / _PI))
    return -torch.abs(t1 * t2) / 10


def _goldstein_price(x):
    """domain [-2, 2]^2, log-transformed"""
    x1, x2 = x[..., 0], x[..., 1]
    p1 = 1 + (x1 + x2 + 1) ** 2 * (19 - 14 * x1 + 3 * x1 ** 2
                                   - 14 * x2 + 6 * x1 * x2 + 3 * x2 ** 2)
    p2 = 30 + (2 * x1 - 3 * x2) ** 2 * (18 - 32 * x1 + 12 * x1 ** 2
                                        + 48 * x2 - 36 * x1 * x2
                                        + 27 * x2 ** 2)
    return (torch.log(p1 * p2) - 6) / 4


# a 1-D domain is a (lo, hi) tuple, a 2-D one a list of them
BENCHMARKS = {
    "forrester": dict(dim=1, domain=(0.0, 1.0), func=_forrester),
    "branin": dict(dim=2, domain=[(0.0, 1.0), (0.0, 1.0)], func=_branin),
    "gramacy1d": dict(dim=1, domain=(0.5, 2.5), func=_gramacy1d),
    "gramacy2d": dict(dim=2, domain=[(-2.0, 6.0), (-2.0, 6.0)],
                      func=_gramacy2d),
    "higdon": dict(dim=1, domain=(0.0, 20.0), func=_higdon),
    "rosenbrock2d": dict(dim=2, domain=[(-2.0, 2.0), (-2.0, 2.0)],
                         func=_rosenbrock),
    "ackley2d": dict(dim=2, domain=[(-2.0, 2.0), (-2.0, 2.0)], func=_ackley),
    "three_hump_camel": dict(dim=2, domain=[(-2.0, 2.0), (-2.0, 2.0)],
                             func=_three_hump_camel),
    "holder_table": dict(dim=2, domain=[(-10.0, 10.0), (-10.0, 10.0)],
                         func=_holder_table),
    "goldstein_price": dict(dim=2, domain=[(-2.0, 2.0), (-2.0, 2.0)],
                            func=_goldstein_price),
}


class BenchmarkTask(Task):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.noise_scale = cfg.noise_scale
        self.benchmark_name = getattr(cfg, "benchmark_name", "forrester")

    def _scale_input_to_domain(self, x_norm: torch.Tensor,
                               benchmark_name: str) -> torch.Tensor:
        """Map [-design_scale, design_scale] onto the function's domain."""
        domain = BENCHMARKS[benchmark_name]["domain"]
        if isinstance(domain, tuple):
            lo, hi = domain
            return (x_norm / self.design_scale) * ((hi - lo) / 2) \
                + (hi + lo) / 2
        return torch.stack([(x_norm[..., i] / self.design_scale)
                            * ((hi - lo) / 2) + (hi + lo) / 2
                            for i, (lo, hi) in enumerate(domain)], dim=-1)

    def _spec(self, name: str):
        spec = BENCHMARKS[name]
        if spec["dim"] != self.dim_x:
            raise ValueError(
                f"benchmark {name} requires dim {spec['dim']}, "
                f"task has dim_x={self.dim_x}")
        return spec

    def observe(self, xi: torch.Tensor, eps: torch.Tensor,
                benchmark_name: Optional[str] = None) -> torch.Tensor:
        """f(xi mapped onto the domain) + noise_scale · eps; xi [B, N, D]
        → [B, N, 1] (or [B, D] → [B, 1]), eps of the output's shape."""
        spec = self._spec(benchmark_name or self.benchmark_name)
        x = self._scale_input_to_domain(xi, benchmark_name
                                        or self.benchmark_name)
        y = spec["func"](x)[..., None]
        return y + self.noise_scale * eps

    def simulate(self, gen: torch.Generator, xi: torch.Tensor,
                 benchmark_name: Optional[str] = None) -> torch.Tensor:
        """Noisy function observations at normalised designs xi."""
        self._spec(benchmark_name or self.benchmark_name)
        eps = torch.randn(xi.shape[:-1] + (1,), generator=gen,
                          device=gen.device, dtype=xi.dtype)
        return self.observe(xi, eps, benchmark_name)

    def sample_data(self, gen: torch.Generator, batch_size: int,
                    n_data: int) -> torch.Tensor:
        u = torch.rand(batch_size, n_data, self.dim_x, generator=gen,
                       device=gen.device)
        return -self.design_scale + 2 * self.design_scale * u

    def batch_from_draws(self, x_all: torch.Tensor, y_all: torch.Tensor,
                         n_query: int, mode: str = "data") -> Batch:
        """The batch of designs ``x_all`` [B, n_context_init + n_query +
        n_target_data, D] and their outcomes.  ``mix`` packs dim_x + 1
        zero theta tokens behind the data targets, as a mix-mode model
        reads them, whatever the task's own embedding type."""
        B = x_all.shape[0]
        n_points = self.n_context_init + n_query
        x, y = x_all[:, :n_points], y_all[:, :n_points]
        target_x, target_y = x_all[:, n_points:], y_all[:, n_points:]
        if mode == "mix":
            theta_tokens = torch.zeros(B, self.dim_x + 1, 1,
                                       device=x.device)
            return self._pack_batch(x, y, target_x, target_y, theta_tokens,
                                    theta_tokens, embedding_type="mix")
        theta_tokens = torch.zeros(B, 0, 1, device=x.device)
        return self._pack_batch(x, y, target_x, target_y, theta_tokens, None)

    def sample_batch(self, gen: torch.Generator, batch_size: int,
                     n_query: Optional[int] = None,
                     benchmark_name: Optional[str] = None,
                     mode: str = "data") -> Batch:
        """Uniform designs and their noisy observations, on the
        generator's device."""
        n_query = self.n_query_init if n_query is None else n_query
        n_total = self.n_context_init + n_query + self.n_target_data
        x_all = self.sample_data(gen, batch_size, n_total)
        y_all = self.simulate(gen, x_all, benchmark_name)
        return self.batch_from_draws(x_all, y_all, n_query, mode)
