"""Masked set-transformer encoder (``aline_tpu/models/encoder.py``).

A stack of post-norm transformer layers (attn → add → norm → relu-FF →
add → norm) whose attention obeys the ALINE role mask, through one of
three cores: compact keys, the flash kernels, or a dense bias (naive).
An optional global time token, ``time_proj(t)``, leads the sequence.
LayerNorm uses flax's epsilon, 1e-6.

``dtype`` is the compute dtype, as flax's ``dtype``: in bfloat16 the dense
layers compute as ``Dense`` does, the attention takes bfloat16 q, k and v,
and each LayerNorm normalises in float32 and rounds once to bfloat16.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from aline_tpu_torch.config import EncoderConfig
from aline_tpu_torch.models.dense import Dense
from aline_tpu_torch.models.init import init_dense_
from aline_tpu_torch.ops.attention import (
    CompactKeys,
    compact_attention,
    dense_bias_attention,
)
from aline_tpu_torch.ops.flash_attention import (
    flash_plan,
    flash_role_attention,
)
from aline_tpu_torch.ops.roles import Roles, attention_bias, roles_to_codes

LAYER_NORM_EPS = 1e-6   # flax.linen.LayerNorm's default

ATTENTION_IMPLS = ("auto", "compact", "flash", "naive")


class MultiHeadSelfAttention(nn.Module):
    """MHA with one q‖k‖v projection and a compact, flash or dense-bias
    core, whichever of ``compact``, ``codes`` and ``bias`` it is given."""

    def __init__(self, dim_embedding: int, n_head: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.n_head = n_head
        self.qkv_proj = Dense(dim_embedding, 3 * dim_embedding, dtype,
                              device)
        self.out_proj = Dense(dim_embedding, dim_embedding, dtype, device)

    def forward(self, x: torch.Tensor, roles: Roles,
                bias: Optional[torch.Tensor] = None,
                compact: Optional[CompactKeys] = None,
                codes: Optional[tuple] = None,
                attn_hook: Optional[Callable] = None) -> torch.Tensor:
        B, N, D = x.shape
        H = self.n_head

        def heads(t):
            return t.reshape(B, N, H, D // H).transpose(1, 2)

        q, k, v = (heads(t) for t in self.qkv_proj(x).chunk(3, dim=-1))
        if compact is not None:
            out = compact_attention(q, k, v, roles, compact)
        elif codes is not None:
            out = flash_role_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), *codes)
        else:
            out = dense_bias_attention(q, k, v, bias)
        if attn_hook is not None:
            out = attn_hook(q, k, v, out)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, D))


class EncoderLayer(nn.Module):
    """Post-norm transformer layer with a relu feed-forward."""

    def __init__(self, dim_embedding: int, dim_feedforward: int,
                 n_head: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiHeadSelfAttention(dim_embedding, n_head, dtype,
                                                device)
        self.norm1 = nn.LayerNorm(dim_embedding, eps=LAYER_NORM_EPS,
                                  device=device)
        self.linear1 = Dense(dim_embedding, dim_feedforward, dtype, device)
        self.linear2 = Dense(dim_feedforward, dim_embedding, dtype, device)
        self.norm2 = nn.LayerNorm(dim_embedding, eps=LAYER_NORM_EPS,
                                  device=device)

    def _norm(self, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        """flax's ``LayerNorm(dtype)``: float32 statistics and
        normalisation, one rounding to the compute dtype."""
        return norm(x.float()).to(self.dtype)

    def forward(self, x: torch.Tensor, roles: Roles,
                bias: Optional[torch.Tensor] = None,
                compact: Optional[CompactKeys] = None,
                codes: Optional[tuple] = None,
                attn_hook: Optional[Callable] = None) -> torch.Tensor:
        x = self._norm(self.norm1,
                       x + self.self_attn(x, roles, bias, compact, codes,
                                          attn_hook))
        return self._norm(self.norm2,
                          x + self.linear2(torch.relu(self.linear1(x))))


class Encoder(nn.Module):
    """``num_layers`` EncoderLayers, registered as ``layer_{i}`` like the
    flax parameter tree, and ``time_proj`` with the time token."""

    def __init__(self, cfg: EncoderConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl="
                             f"{cfg.attention_impl!r}; one of "
                             f"{ATTENTION_IMPLS}")
        # cfg.dropout is not read: inference runs without dropout, as the
        # JAX encoder does with deterministic=True.
        self.num_layers = cfg.num_layers
        self.impl = cfg.attention_impl
        self.with_time_token = cfg.with_time_token
        if cfg.with_time_token:
            self.time_proj = Dense(1, cfg.dim_embedding, dtype, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                cfg.dim_embedding, cfg.dim_feedforward, cfg.n_head, dtype,
                device))
        init_dense_(self)

    def forward(self, tokens: torch.Tensor, roles: Roles,
                t: Optional[torch.Tensor] = None,
                compact: Optional[CompactKeys] = None,
                attn_hook: Optional[Callable] = None) -> torch.Tensor:
        """[B, N, D] tokens (without the time token) and the [] time
        scalar ``t`` (read with the time token) → [B, N(+1), D] encoded
        tokens, the time token first.  ``roles`` are sized for the time
        token.  ``attn_hook(q, k, v, out)``, where given, returns each
        layer's attention output [B, H, N, dh] in place of ``out``."""
        if self.with_time_token:
            t_emb = self.time_proj(t.reshape(1, 1).to(tokens.dtype))
            tokens = torch.cat([t_emb[None].expand(tokens.shape[0], 1, -1),
                                tokens], dim=1)
        # the flash kernels make the mask from the role codes and walk the
        # plan of it, one for every layer and head: no bias
        bias = codes = None
        if compact is None and self.impl == "flash":
            kcode, qrow = roles_to_codes(roles)
            codes = (kcode, qrow, flash_plan(kcode, qrow))
        elif compact is None:
            bias = attention_bias(roles, tokens.dtype)
        x = tokens
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, roles, bias, compact, codes,
                                            attn_hook)
        return x
