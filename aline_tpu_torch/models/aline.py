"""Aline composition root: embedder → masked encoder → output head
(``aline_tpu/models/aline.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aline_tpu_torch.config import Config
from aline_tpu_torch.models.embedder import Embedder
from aline_tpu_torch.models.encoder import Encoder
from aline_tpu_torch.models.heads import (
    AlineOutput,
    ContinuousOutputHead,
    OutputHead,
)
from aline_tpu_torch.ops.attention import CompactKeys, context_indices
from aline_tpu_torch.ops.roles import build_roles
from aline_tpu_torch.tasks.base import Batch


class Aline(nn.Module):
    def __init__(self, embedder: Embedder, encoder: Encoder,
                 head: nn.Module):
        super().__init__()
        self.embedder = embedder
        self.encoder = encoder
        self.head = head

    def forward(self, batch: Batch, *, training: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                sel_targets: Optional[tuple] = None,
                query_posterior: bool = True) -> AlineOutput:
        """``training`` samples the design from ``noise`` (Gumbel-max for
        the discrete head, mean + std · noise for the continuous one), or
        from noise drawn from ``generator``, instead of taking the greedy
        design.
        ``sel_targets``: static tuple of the target indices where
        ``batch.target_mask`` is True; the compact path then drops the
        never-visible target key columns (exact).  ``query_posterior``:
        see ``OutputHead.forward``.  ``batch.t`` feeds the time token and
        the design head's time feature, where the config has them."""
        tokens = self.embedder(batch)
        t_off = int(self.encoder.with_time_token)
        roles = build_roles(batch.ctx_mask, tokens.shape[1] - batch.n_points,
                            batch.target_mask, self.encoder.with_time_token)
        compact = None
        if (self.encoder.impl in ("compact", "auto")
                and batch.ctx_capacity > 0):
            if batch.ctx_idx is not None:
                # the incrementally kept index buffer: no per-step sort
                count = batch.ctx_mask.sum(dim=1)
                valid = (torch.arange(batch.ctx_capacity,
                                      device=count.device)[None]
                         < count[:, None])
                idx = batch.ctx_idx + t_off
            else:
                idx, valid = context_indices(batch.ctx_mask,
                                             batch.ctx_capacity, t_off)
            compact = CompactKeys(idx, valid, batch.n_points, sel_targets,
                                  t_off)
        z = self.encoder(tokens, roles, batch.t, compact=compact)
        return self.head(batch, z, training=training, generator=generator,
                         noise=noise, query_posterior=query_posterior,
                         time_offset=t_off)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    """The model's compute dtype: ``cfg.dtype`` where it is not float32,
    else ``cfg.encoder.dtype``, as the JAX ``build_model`` sets it."""
    name = cfg.dtype if cfg.dtype != "float32" else cfg.encoder.dtype
    if name not in COMPUTE_DTYPES:
        raise NotImplementedError(f"dtype={name!r}; the port computes in "
                                  f"{tuple(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def build_model(cfg: Config, device) -> Aline:
    """The model of a run config on ``device``: float32 parameters,
    computing in ``compute_dtype(cfg)`` (the embedder, the encoder and the
    heads; the continuous policy in float32), as the JAX model does."""
    if cfg.task.dim_y != 1:
        raise NotImplementedError("the GMM head takes scalar targets")
    enc = cfg.encoder
    dtype = compute_dtype(cfg)
    embedder = Embedder(
        dim_x=cfg.task.dim_x, dim_y=cfg.task.dim_y,
        dim_embedding=enc.dim_embedding, dim_feedforward=enc.dim_feedforward,
        n_target_theta=(cfg.task.n_target_theta
                        if cfg.task.embedding_type in ("theta", "mix")
                        else 0),
        embedding_type=cfg.task.embedding_type,
        continuous=cfg.embedder.continuous, dtype=dtype, device=device)
    h = cfg.head
    common = dict(num_components=h.num_components, std_min=h.std_min,
                  time_token=cfg.time_token, device=device, dtype=dtype,
                  fused_gmm=h.fused_gmm, single_head=h.single_head)
    if h.continuous:
        head = ContinuousOutputHead(
            cfg.task.dim_x, enc.dim_embedding, enc.dim_feedforward,
            log_std_min=h.policy_log_std_min,
            log_std_max=h.policy_log_std_max, **common)
    else:
        head = OutputHead(enc.dim_embedding, enc.dim_feedforward,
                          value_head=h.value_head, **common)
    return Aline(embedder, Encoder(enc, device, dtype), head)
