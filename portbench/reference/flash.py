"""The encoder of ``model.py`` with its attention in the precision of the
flash kernels (a configuration whose ``precision.attention`` is
``flash_bf16``): the scores q·kᵀ of the rounded q and k, scaled, the
masked softmax and P·V all in float32, and O rounded once.  The dense
path of ``model.encoder`` rounds the scores and P as well, as flax's
``dtype`` does.

The flash kernels replace a masked score by -1e9 over a padded key axis,
so a row that sees no key averages v over the padded columns; a row that
sees a key gives the dense masked softmax, the only case here (the
training traffic's context is never empty).  Nothing of the port is
imported.
"""
from __future__ import annotations

import contextlib
import math

import torch

from portbench.reference import model
from portbench.reference.model import NEG, dense, layer_norm


def encoder(P, h, allowed, n_layers, n_head, r):
    B, N, D = h.shape
    dh = D // n_head
    bias = torch.where(allowed, 0.0, NEG)[:, None]          # [B, 1, N, N]
    for i in range(n_layers):
        pre = f"encoder/layer_{i}"
        qkv = dense(P, pre + "/self_attn/qkv_proj", h, r)
        q, k, v = (t.reshape(B, N, n_head, dh).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh) + bias,
                          dim=-1)
        o = r(p @ v).transpose(1, 2).reshape(B, N, D)
        a = dense(P, pre + "/self_attn/out_proj", o, r)
        h = layer_norm(P, pre + "/norm1", r(h + a), r)
        f = dense(P, pre + "/linear2",
                  torch.relu(dense(P, pre + "/linear1", h, r)), r)
        h = layer_norm(P, pre + "/norm2", r(h + f), r)
    return h


@contextlib.contextmanager
def attention(precision: dict):
    """``model.forward`` with the attention of the configuration's
    ``precision`` (``flash_bf16``: this module's encoder) inside the
    block; the dense path where it names none."""
    if precision.get("attention") != "flash_bf16":
        yield
        return
    dense_encoder = model.encoder
    model.encoder = encoder
    try:
        yield
    finally:
        model.encoder = dense_encoder
