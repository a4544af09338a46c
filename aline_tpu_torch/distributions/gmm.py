"""Mixture-of-Gaussians primitives (``aline_tpu/distributions/gmm.py``).

The trailing axis of ``means``/``stds``/``weights`` is the component axis
C; ``value`` has the shape of ``means`` without C.
"""
from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def normal_log_prob(value, loc, scale):
    """Elementwise Normal log-density (broadcasting); ``scale`` may be a
    tensor or a Python number."""
    z = (value - loc) / scale
    log_scale = (torch.log(scale) if isinstance(scale, torch.Tensor)
                 else math.log(scale))
    return -0.5 * (z * z + _LOG_2PI) - log_scale


def gmm_log_prob(value, means, stds, weights):
    """``logsumexp_c [N(value | m_c, s_c) + log w_c]`` → shape of value."""
    lp = normal_log_prob(value[..., None], means, stds)
    return torch.logsumexp(lp + torch.log(weights), dim=-1)


def gmm_mean(means, weights):
    return torch.sum(weights * means, dim=-1)


def gmm_variance(means, stds, weights):
    mean = gmm_mean(means, weights)
    second = torch.sum(weights * (means ** 2 + stds ** 2), dim=-1)
    return second - mean ** 2
