"""A dense layer that computes in a chosen dtype, as ``flax.linen.Dense``
with ``dtype`` does (its parameters stay float32).

In float32 it is ``nn.Linear``.  In bfloat16 the input, weight and bias
are cast to bfloat16 at each call; the product is summed in float32 and
rounded to bfloat16 once, and the bias is then added in bfloat16, which
rounds a second time.  A fused ``F.linear(x, W, b)`` rounds once, so it
differs from flax in about a quarter of the elements.
"""
from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` (same ``weight`` and ``bias``) computing in
    ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        cd = self.compute_dtype
        w = self.weight.to(cd).float()
        y = torch.matmul(x.to(cd).float(), w.t()).to(cd)
        return y + self.bias.to(cd)
