"""Flax's default initialisers, so a fresh port model starts from the
distribution a fresh ``aline_tpu`` model starts from.

Every flax ``Dense`` draws its kernel from ``lecun_normal`` (a normal of
variance 1/fan_in, truncated at ±2σ and rescaled by 0.87962566 so that
the truncated draw keeps that variance) and zeroes its bias.  The GMM
head's stacked ``[C, D, F]`` and ``[C, F, 3]`` kernels take flax's fans,
C·D and C·F: flax counts the leading axis as a receptive field.
"""
from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated at ±2 (flax's variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(tensor: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Fill ``tensor`` as ``flax.linen.initializers.lecun_normal`` does."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(tensor, std=std, a=-2 * std, b=2 * std)


@torch.no_grad()
def init_dense_(module: nn.Module) -> nn.Module:
    """Every ``nn.Linear`` under ``module`` as a flax ``Dense``: lecun
    normal weight (fan_in = in_features), zero bias."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features)
            if m.bias is not None:
                m.bias.zero_()
    return module
