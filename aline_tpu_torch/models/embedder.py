"""Token embedder (``aline_tpu/models/embedder.py``).

Sequence layout ``[points (initial context + query pool) | target_data |
theta]``: context tokens carry x+y embeddings, pool and target-data
tokens x only, theta targets are learned per-dimension tokens.  With
``dtype`` bfloat16 the points are cast to it and every segment comes out
in it, as flax's ``dtype`` makes them.
"""
from __future__ import annotations

import torch
from torch import nn

from aline_tpu_torch.models.dense import Dense
from aline_tpu_torch.models.init import init_dense_
from aline_tpu_torch.tasks.base import Batch


class MLPEmbed(nn.Module):
    """Linear → ReLU → Linear."""

    def __init__(self, dim_in: int, dim_feedforward: int,
                 dim_embedding: int, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = Dense(dim_in, dim_feedforward, dtype, device)
        self.fc2 = Dense(dim_feedforward, dim_embedding, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class Embedder(nn.Module):
    def __init__(self, dim_x: int, dim_y: int, dim_embedding: int,
                 dim_feedforward: int, n_target_theta: int = 0,
                 embedding_type: str = "data", dtype=torch.float32,
                 device=None):
        super().__init__()
        if embedding_type not in ("data", "theta", "mix"):
            raise NotImplementedError(
                f"embedding_type={embedding_type!r} is not ported yet")
        self.embedding_type = embedding_type
        self.dtype = dtype
        self.n_target_theta = n_target_theta
        if embedding_type in ("theta", "mix"):
            if n_target_theta <= 0:
                raise ValueError("n_target_theta must be positive for theta "
                                 "or mix embedding type")
            self.theta_tokens = nn.Parameter(torch.empty(
                n_target_theta, dim_embedding, device=device).normal_())
        self.x_embedder = MLPEmbed(dim_x, dim_feedforward, dim_embedding,
                                   dtype, device)
        self.y_embedder = MLPEmbed(dim_y, dim_feedforward, dim_embedding,
                                   dtype, device)
        init_dense_(self)

    def forward(self, batch: Batch) -> torch.Tensor:
        """[B, N, D] tokens, N = n_points + n_target_data (data/mix)
        + n_target_theta (theta/mix)."""
        pts = self.x_embedder(batch.x.to(self.dtype))
        y_emb = self.y_embedder(batch.y.to(self.dtype))
        pts = pts + y_emb * batch.ctx_mask[..., None].to(pts.dtype)
        segments = [pts]
        if self.embedding_type in ("data", "mix"):
            segments.append(self.x_embedder(batch.target_x))
        if self.embedding_type in ("theta", "mix"):
            segments.append(self.theta_tokens[None].expand(
                batch.batch_size, -1, -1).to(pts.dtype))
        return torch.cat(segments, dim=1)
