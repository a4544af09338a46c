"""Output heads: acquisition policy and GMM posterior
(``aline_tpu/models/heads.py``).

Module names keep the JAX package's names (``predictor_fc1``,
``heads_w1``, ...) so the flax parameter tree converts by renaming.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aline_tpu_torch.models.init import init_dense_, lecun_normal_
from aline_tpu_torch.ops.gmm_head_kernel import gmm_head
from aline_tpu_torch.ops.roles import NEG_INF
from aline_tpu_torch.tasks.base import Batch


@dataclass
class GMMParams:
    """Posterior mixture parameters, each [B, n_tokens, C]."""
    mixture_means: torch.Tensor
    mixture_stds: torch.Tensor
    mixture_weights: torch.Tensor


@dataclass
class DesignOut:
    idx: torch.Tensor        # [B] chosen point index
    log_prob: torch.Tensor   # [B] log prob of the choice
    zt: torch.Tensor         # [B, n_points] selection probabilities


@dataclass
class AlineOutput:
    design_out: DesignOut
    posterior_out: GMMParams
    posterior_out_query: Optional[GMMParams]


class AcquisitionHead(nn.Module):
    """Raw per-candidate design scores [B, n_points] (float32)."""

    def __init__(self, dim_embedding: int, dim_feedforward: int,
                 device=None):
        super().__init__()
        self.predictor_fc1 = nn.Linear(dim_embedding, dim_feedforward,
                                       device=device)
        self.predictor_fc2 = nn.Linear(dim_feedforward, 1, device=device)
        init_dense_(self)

    def forward(self, z_query: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.predictor_fc1(z_query))
        return self.predictor_fc2(h)[..., 0].float()


class GMMTargetHead(nn.Module):
    """``num_components`` independent 2-layer MLPs per token, as stacked
    [C, ...] parameters, each emitting (mean, raw std, raw weight).

    Every token set goes through ``gmm_head``: the CUDA kernels (forward,
    and backward when a gradient is taken) on the card, whatever the token
    count, and the plain versions on the CPU.
    """

    def __init__(self, dim_embedding: int, dim_feedforward: int,
                 num_components: int, std_min: float = 1e-4, device=None):
        super().__init__()
        C, D, Fd = num_components, dim_embedding, dim_feedforward
        self.std_min = std_min
        self.heads_w1 = nn.Parameter(torch.empty(C, D, Fd, device=device))
        self.heads_b1 = nn.Parameter(torch.zeros(C, Fd, device=device))
        self.heads_w2 = nn.Parameter(torch.empty(C, Fd, 3, device=device))
        self.heads_b2 = nn.Parameter(torch.zeros(C, 3, device=device))
        # flax's lecun_normal counts the stacked C axis into the fan
        lecun_normal_(self.heads_w1, C * D)
        lecun_normal_(self.heads_w2, C * Fd)

    def forward(self, z: torch.Tensor) -> GMMParams:
        out = gmm_head(z.float().contiguous(), self.heads_w1,
                       self.heads_b1, self.heads_w2, self.heads_b2)
        raw_mean, raw_std, raw_w = out.unbind(-1)           # [B, T, C] each
        std = F.softplus(raw_std) + self.std_min
        return GMMParams(raw_mean, std, torch.softmax(raw_w, dim=-1))


class OutputHead(nn.Module):
    """Splits the encoder output into point and target tokens, picks a
    design from the pool and predicts both posteriors."""

    def __init__(self, dim_embedding: int, dim_feedforward: int,
                 num_components: int = 10, std_min: float = 1e-4,
                 device=None):
        super().__init__()
        self.acquisition_head = AcquisitionHead(dim_embedding,
                                                dim_feedforward, device)
        self.target_head = GMMTargetHead(dim_embedding, dim_feedforward,
                                         num_components, std_min, device)

    def forward(self, batch: Batch, z: torch.Tensor, *, training: bool,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None,
                query_posterior: bool = True) -> AlineOutput:
        """``training`` draws the design by Gumbel-max, as
        ``jax.random.categorical`` does: argmax of the logits plus
        ``gumbel`` [B, n_points] standard Gumbel noise, drawn from
        ``generator`` when not given.  Passing the noise in keeps a
        recomputed step (``torch.utils.checkpoint``) on the design it drew
        first.  ``query_posterior=False`` skips the pool tokens'
        posterior, which the training loss does not read."""
        n_points = batch.n_points
        z_points, z_target = z[:, :n_points], z[:, n_points:]
        scores = self.acquisition_head(z_points)
        pool = batch.query_mask
        logits = torch.where(pool, scores,
                             torch.full((), NEG_INF, device=scores.device))
        log_probs = torch.log_softmax(logits, dim=-1)
        if training:
            if gumbel is None:
                gumbel = gumbel_noise(logits.shape, generator)
            idx = torch.argmax(logits + gumbel, dim=-1)
        else:
            idx = torch.argmax(log_probs, dim=-1)
        b = torch.arange(z.shape[0], device=z.device)
        zt = torch.where(pool, log_probs.exp(),
                         torch.zeros((), device=z.device))
        return AlineOutput(
            design_out=DesignOut(idx=idx, log_prob=log_probs[b, idx], zt=zt),
            posterior_out=self.target_head(z_target),
            posterior_out_query=(self.target_head(z_points)
                                 if query_posterior else None))


def gumbel_noise(shape, generator: Optional[torch.Generator]
                 ) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in (0, 1), on
    the generator's device."""
    device = generator.device if generator is not None else None
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))
