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

from aline_tpu_torch.models.dense import Dense
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
    """Raw per-candidate design scores [B, n_points] (float32, computed in
    ``dtype``).  With ``time_token`` the time scalar, cast to z's dtype,
    joins every candidate's features."""

    def __init__(self, dim_embedding: int, dim_feedforward: int,
                 time_token: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.time_token = time_token
        self.predictor_fc1 = Dense(dim_embedding + int(time_token),
                                   dim_feedforward, dtype, device)
        self.predictor_fc2 = Dense(dim_feedforward, 1, dtype, device)
        init_dense_(self)

    def forward(self, z_query: torch.Tensor,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.time_token:
            B, N, _ = z_query.shape
            t_feat = t.reshape(1, 1, 1).to(z_query.dtype).expand(B, N, 1)
            z_query = torch.cat([z_query, t_feat], dim=-1)
        h = torch.relu(self.predictor_fc1(z_query))
        return self.predictor_fc2(h)[..., 0].float()


# token count from which ``fused_gmm=auto`` takes the kernel in bfloat16
# (the JAX head's rule on a TPU)
FUSED_MIN_TOKENS = 1024


class GMMTargetHead(nn.Module):
    """``num_components`` independent 2-layer MLPs per token, as stacked
    [C, ...] parameters, each emitting (mean, raw std, raw weight).

    A token set takes one of two paths, chosen by ``fused``
    (``head.fused_gmm``) as the JAX head chooses on a TPU:

    * ``gmm_head`` on ``z.float()``, in float32: the CUDA kernels (forward,
      and backward when a gradient is taken) on the card, the plain
      versions on the CPU;
    * the two einsums in the compute ``dtype``, ``relu(z·W1 + b1)·W2``
      rounded to ``dtype`` at each step, then ``+ b2`` in float32.

    ``on`` takes the kernel and ``off`` the einsums for every token set.
    ``auto`` takes the kernel for every token set in float32 (the two paths
    compute the same function there), and in bfloat16 for sets of
    ``FUSED_MIN_TOKENS`` tokens or more only.
    """

    def __init__(self, dim_embedding: int, dim_feedforward: int,
                 num_components: int, std_min: float = 1e-4, device=None,
                 *, dtype=torch.float32, fused: str = "auto"):
        super().__init__()
        if fused not in ("auto", "on", "off"):
            raise ValueError(f"fused_gmm={fused!r}; one of auto, on, off")
        C, D, Fd = num_components, dim_embedding, dim_feedforward
        self.std_min = std_min
        self.dtype = dtype
        self.fused = fused
        self.heads_w1 = nn.Parameter(torch.empty(C, D, Fd, device=device))
        self.heads_b1 = nn.Parameter(torch.zeros(C, Fd, device=device))
        self.heads_w2 = nn.Parameter(torch.empty(C, Fd, 3, device=device))
        self.heads_b2 = nn.Parameter(torch.zeros(C, 3, device=device))
        # flax's lecun_normal counts the stacked C axis into the fan
        lecun_normal_(self.heads_w1, C * D)
        lecun_normal_(self.heads_w2, C * Fd)

    def use_kernel(self, n_tokens: int) -> bool:
        """Whether a set of ``n_tokens`` tokens takes ``gmm_head``."""
        if self.fused != "auto":
            return self.fused == "on"
        return (self.dtype == torch.float32
                or n_tokens >= FUSED_MIN_TOKENS)

    def forward(self, z: torch.Tensor) -> GMMParams:
        if self.use_kernel(z.shape[1]):
            out = gmm_head(z.float().contiguous(), self.heads_w1,
                           self.heads_b1, self.heads_w2, self.heads_b2)
        else:
            cd = self.dtype

            def einsum(eq, a, w):
                # rounded from a float32 sum, as models/dense.py does: a
                # bfloat16 einsum on the CPU reduces these widths (32, 128)
                # otherwise than XLA and differs from it in a few elements
                return torch.einsum(eq, a.to(cd).float(),
                                    w.to(cd).float()).to(cd)

            h = torch.relu(einsum("btd,cdf->btcf", z, self.heads_w1)
                           + self.heads_b1.to(cd))
            out = (einsum("btcf,cfo->btco", h, self.heads_w2).float()
                   + self.heads_b2)
        raw_mean, raw_std, raw_w = out.unbind(-1)           # [B, T, C] each
        std = F.softplus(raw_std) + self.std_min
        return GMMParams(raw_mean, std, torch.softmax(raw_w, dim=-1))


class OutputHead(nn.Module):
    """Splits the encoder output into point and target tokens, picks a
    design from the pool and predicts both posteriors."""

    def __init__(self, dim_embedding: int, dim_feedforward: int,
                 num_components: int = 10, std_min: float = 1e-4,
                 time_token: bool = False, device=None, *,
                 dtype=torch.float32, fused_gmm: str = "auto"):
        super().__init__()
        self.acquisition_head = AcquisitionHead(
            dim_embedding, dim_feedforward, time_token, dtype, device)
        self.target_head = GMMTargetHead(dim_embedding, dim_feedforward,
                                         num_components, std_min, device,
                                         dtype=dtype, fused=fused_gmm)

    def forward(self, batch: Batch, z: torch.Tensor, *, training: bool,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None,
                query_posterior: bool = True,
                time_offset: int = 0) -> AlineOutput:
        """``z`` is the encoder output [B, time? + n_points + n_target, D];
        ``time_offset`` is 1 when a time token leads it.  ``training``
        draws the design by Gumbel-max, as
        ``jax.random.categorical`` does: argmax of the logits plus
        ``gumbel`` [B, n_points] standard Gumbel noise, drawn from
        ``generator`` when not given.  Passing the noise in keeps a
        recomputed step (``torch.utils.checkpoint``) on the design it drew
        first.  ``query_posterior=False`` skips the pool tokens'
        posterior, which the training loss does not read."""
        n_points = batch.n_points
        z_points = z[:, time_offset:time_offset + n_points]
        z_target = z[:, time_offset + n_points:]
        scores = self.acquisition_head(z_points, batch.t)
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
