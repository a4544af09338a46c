"""Normal distribution truncated from below
(``aline_tpu/distributions/truncated_normal.py``).

Inverse-CDF sampling, erf/erfinv-based cdf and icdf, and the log-density
``log N(x) - log Phi((loc - truncation) / scale)`` (by the Normal's
symmetry, P(X > truncation)).  No task samples from it;
the JAX package exports it, and so does the port.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from aline_tpu_torch.distributions.censored_sigmoid_normal import f32_tensor

_SQRT2 = math.sqrt(2.0)
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class LowerTruncatedNormal:
    def __init__(self, loc, scale, truncation):
        loc = f32_tensor(loc)
        self.loc, self.scale, self.truncation = torch.broadcast_tensors(
            loc, f32_tensor(scale, loc.device),
            f32_tensor(truncation, loc.device))

    # -- internals --------------------------------------------------------
    def _normal_log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - _LOG_SQRT_2PI

    def _normal_cdf(self, value):
        return 0.5 * (1.0 + torch.erf((value - self.loc)
                                      / (self.scale * _SQRT2)))

    def _normal_icdf(self, value):
        return self.loc + self.scale * _SQRT2 * torch.special.erfinv(
            2.0 * value - 1.0)

    # -- public API -------------------------------------------------------
    def sample_from_uniform(self, u: torch.Tensor) -> torch.Tensor:
        """The sample for uniform draws ``u`` in [0, 1): the inverse CDF,
        with a numerical undershoot of the truncation clamped to it."""
        raw = self.icdf(u)
        return torch.relu(raw - self.truncation) + self.truncation

    def rsample(self, gen: torch.Generator,
                sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        u = torch.rand(shape, generator=gen, device=gen.device,
                       dtype=self.loc.dtype)
        return self.sample_from_uniform(u)

    sample = rsample

    def log_prob(self, value):
        # log Phi by log_ndtr, not the reference's log(0.5 (1 + erf)):
        # the two agree in the body, and log_ndtr keeps the deep tail,
        # where 1 + erf rounds to 0 in torch's float32 (2 ulps in XLA's)
        return self._normal_log_prob(value) - torch.special.log_ndtr(
            (self.loc - self.truncation) / self.scale)

    def cdf(self, value):
        return torch.clamp(
            self._normal_cdf(value) - self._normal_cdf(self.truncation),
            min=0.0)

    def icdf(self, value):
        cdf_trunc = self._normal_cdf(self.truncation)
        rescaled = cdf_trunc + (1.0 - cdf_trunc) * value
        return self._normal_icdf(rescaled)
