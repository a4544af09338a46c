"""Sigmoid-transformed Normal censored to ``[lower_lim, upper_lim]``
(``aline_tpu/distributions/censored_sigmoid_normal.py``).

A Normal pushed through a sigmoid, with probability mass at the
censoring limits; the CES task's response (``tasks/ces.py``).  The
log-mass at a limit is ``log_ndtr`` of the limit's z-score (exact in the
deep tail), or, with ``tail_mode="reference"``, the reference's
hand-rolled branch reproduced bit for bit in its branch choice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from aline_tpu_torch.distributions.gmm import normal_log_prob

# torch's float32 erf rounds to exactly +-1 from here on; written out, so
# that the branch choice of the reference tail does not depend on the
# erf of the device (a card's erff may saturate elsewhere)
ERF_SATURATES = 3.8325101
# the reference's switch to its asymptote: the tail CDF below 2 * tiny
_CRIT = 2.0 * torch.finfo(torch.float32).tiny


def f32_tensor(v, device=None) -> torch.Tensor:
    """``v`` as a float32 tensor on ``device``; a Python number is filled
    in on the device (a copy from the host would wait for the card)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _logit(y):
    return torch.log(y) - torch.log1p(-y)


def _erf_saturated(x):
    return torch.where(torch.abs(x) >= ERF_SATURATES, torch.sign(x),
                       torch.erf(x))


class CensoredSigmoidNormal:
    def __init__(self, loc, scale, lower_lim, upper_lim,
                 tail_mode: str = "log_ndtr"):
        """``loc``, ``scale``: float32 tensors (broadcastable); the limits
        Python numbers or tensors.  ``tail_mode``: ``"log_ndtr"`` (the
        default) or ``"reference"``."""
        if tail_mode not in ("log_ndtr", "reference"):
            raise ValueError(f"unknown tail_mode {tail_mode!r}")
        self.tail_mode = tail_mode
        loc = f32_tensor(loc)
        self.loc, self.scale = torch.broadcast_tensors(
            loc, f32_tensor(scale, loc.device))
        self.upper_lim, self.lower_lim = torch.broadcast_tensors(
            f32_tensor(upper_lim, loc.device),
            f32_tensor(lower_lim, loc.device))

    # -- base (sigmoid-normal) distribution -------------------------------
    def _z(self, value):
        return (_logit(value) - self.loc) / self.scale

    def _base_log_prob(self, value):
        """N(logit(v)) - log(v (1 - v)): the density of sigmoid(Normal)."""
        return (normal_log_prob(_logit(value), self.loc, self.scale)
                - torch.log(value) - torch.log1p(-value))

    def _base_cdf(self, value):
        return torch.special.ndtr(self._z(value))

    # -- public API -------------------------------------------------------
    def sample_from_normal(self, eps: torch.Tensor) -> torch.Tensor:
        """The sample for standard normal draws ``eps``: sigmoid of
        loc + scale * eps, clamped to the limits (so a draw beyond a limit
        is that limit exactly)."""
        x = torch.sigmoid(self.loc + self.scale * eps)
        return torch.clamp(x, self.lower_lim, self.upper_lim)

    def rsample(self, gen: torch.Generator,
                sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        eps = torch.randn(shape, generator=gen, device=gen.device,
                          dtype=self.loc.dtype)
        return self.sample_from_normal(eps)

    sample = rsample

    def log_prob(self, value):
        value, upper_lim, lower_lim = torch.broadcast_tensors(
            value, self.upper_lim, self.lower_lim)
        log_prob = self._base_log_prob(value)
        z_upper, z_lower = self._z(upper_lim), self._z(lower_lim)
        if self.tail_mode == "log_ndtr":
            upper_logcdf = torch.special.log_ndtr(-z_upper)
            lower_logcdf = torch.special.log_ndtr(z_lower)
        else:
            # the reference's branches: log(cdf) from a float32 erf until
            # the tail CDF falls below 2 * tiny, then the transformed
            # density at the limit less log(crit + |z|).  sqrt(2) is a
            # tensor on the device: a CUDA division by a host scalar
            # multiplies by its reciprocal, which rounds differently.
            sqrt2 = torch.full((), 2.0, device=value.device).sqrt()
            upper_cdf = 1.0 - 0.5 * (1.0 + _erf_saturated(z_upper / sqrt2))
            lower_cdf = 0.5 * (1.0 + _erf_saturated(z_lower / sqrt2))
            asym_upper = (self._base_log_prob(upper_lim)
                          - torch.log(_CRIT + torch.abs(z_upper)))
            asym_lower = (self._base_log_prob(lower_lim)
                          - torch.log(_CRIT + torch.abs(z_lower)))
            upper_logcdf = torch.where(upper_cdf < _CRIT, asym_upper,
                                       torch.log(upper_cdf))
            lower_logcdf = torch.where(lower_cdf < _CRIT, asym_lower,
                                       torch.log(lower_cdf))
        log_prob = torch.where(value == upper_lim, upper_logcdf, log_prob)
        log_prob = torch.where(value == lower_lim, lower_logcdf, log_prob)
        log_prob = torch.where(value > upper_lim, -torch.inf, log_prob)
        return torch.where(value < lower_lim, -torch.inf, log_prob)

    def cdf(self, value):
        cdf_val = self._base_cdf(value)
        cdf_val = torch.where(value >= self.upper_lim, 1.0, cdf_val)
        return torch.where(value < self.lower_lim, 0.0, cdf_val)
