"""Masked set-transformer encoder (``aline_tpu/models/encoder.py``).

A stack of post-norm transformer layers (attn → add → norm → relu-FF →
add → norm) whose attention obeys the ALINE role mask.  LayerNorm uses
flax's epsilon, 1e-6.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aline_tpu_torch.config import EncoderConfig
from aline_tpu_torch.models.init import init_dense_
from aline_tpu_torch.ops.attention import (
    CompactKeys,
    compact_attention,
    dense_bias_attention,
)
from aline_tpu_torch.ops.roles import Roles, attention_bias

LAYER_NORM_EPS = 1e-6   # flax.linen.LayerNorm's default

ATTENTION_IMPLS = ("auto", "compact", "naive")


class MultiHeadSelfAttention(nn.Module):
    """MHA with one q‖k‖v projection and a compact or dense-bias core."""

    def __init__(self, dim_embedding: int, n_head: int, device=None):
        super().__init__()
        self.n_head = n_head
        self.qkv_proj = nn.Linear(dim_embedding, 3 * dim_embedding,
                                  device=device)
        self.out_proj = nn.Linear(dim_embedding, dim_embedding,
                                  device=device)

    def forward(self, x: torch.Tensor, roles: Roles,
                bias: Optional[torch.Tensor] = None,
                compact: Optional[CompactKeys] = None) -> torch.Tensor:
        B, N, D = x.shape
        H = self.n_head

        def heads(t):
            return t.reshape(B, N, H, D // H).transpose(1, 2)

        q, k, v = (heads(t) for t in self.qkv_proj(x).chunk(3, dim=-1))
        if compact is not None:
            out = compact_attention(q, k, v, roles, compact)
        else:
            out = dense_bias_attention(q, k, v, bias)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, D))


class EncoderLayer(nn.Module):
    """Post-norm transformer layer with a relu feed-forward."""

    def __init__(self, dim_embedding: int, dim_feedforward: int,
                 n_head: int, device=None):
        super().__init__()
        self.self_attn = MultiHeadSelfAttention(dim_embedding, n_head,
                                                device)
        self.norm1 = nn.LayerNorm(dim_embedding, eps=LAYER_NORM_EPS,
                                  device=device)
        self.linear1 = nn.Linear(dim_embedding, dim_feedforward,
                                 device=device)
        self.linear2 = nn.Linear(dim_feedforward, dim_embedding,
                                 device=device)
        self.norm2 = nn.LayerNorm(dim_embedding, eps=LAYER_NORM_EPS,
                                  device=device)

    def forward(self, x: torch.Tensor, roles: Roles,
                bias: Optional[torch.Tensor] = None,
                compact: Optional[CompactKeys] = None) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, roles, bias, compact))
        return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))


class Encoder(nn.Module):
    """``num_layers`` EncoderLayers, registered as ``layer_{i}`` like the
    flax parameter tree."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise NotImplementedError(
                f"attention_impl={cfg.attention_impl!r} is not ported yet "
                f"(ported: {ATTENTION_IMPLS})")
        if cfg.with_time_token:
            raise NotImplementedError("the time token is not ported yet")
        # cfg.dropout is not read: inference runs without dropout, as the
        # JAX encoder does with deterministic=True.
        self.num_layers = cfg.num_layers
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                cfg.dim_embedding, cfg.dim_feedforward, cfg.n_head, device))
        init_dense_(self)

    def forward(self, tokens: torch.Tensor, roles: Roles,
                compact: Optional[CompactKeys] = None) -> torch.Tensor:
        """[B, N, D] tokens → [B, N, D] encoded tokens."""
        bias = attention_bias(roles, tokens.dtype) if compact is None \
            else None
        x = tokens
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, roles, bias, compact)
        return x
