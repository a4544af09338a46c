"""Output heads: acquisition policy (discrete or a Gaussian policy over
continuous designs), GMM posterior and value critic
(``aline_tpu/models/heads.py``).

Module names keep the JAX package's names (``predictor_fc1``,
``heads_w1``, ...) so the flax parameter tree converts by renaming.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
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
class ContinuousDesignOut:
    xi: torch.Tensor         # [B, 1, dim_x] emitted design (normalised)
    log_prob: torch.Tensor   # [B] Gaussian policy log-prob of xi
    mean: torch.Tensor       # [B, 1, dim_x]
    std: torch.Tensor        # [B, 1, dim_x]


@dataclass
class AlineOutput:
    design_out: Union[DesignOut, ContinuousDesignOut]
    posterior_out: GMMParams
    posterior_out_query: Optional[GMMParams]
    value: Optional[torch.Tensor] = None     # [B], with head.value_head


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
            z_query = _with_time(z_query, t)
        h = torch.relu(self.predictor_fc1(z_query))
        return self.predictor_fc2(h)[..., 0].float()


def _with_time(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """z [B, N, D] with the time scalar, cast to z's dtype, appended to
    every token's features."""
    B, N, _ = z.shape
    return torch.cat([z, t.reshape(1, 1, 1).to(z.dtype).expand(B, N, 1)],
                     dim=-1)


# log(2π) as JAX takes it in float32
_LOG_2PI_F32 = float(np.log(np.float32(2.0 * math.pi)))


class ContinuousAcquisitionHead(nn.Module):
    """Gaussian design policy: (mean, std) [B, N, dim_x] from two MLPs.
    flax's ``Dense`` without a ``dtype`` computes in the promoted dtype,
    float32, whatever the encoder's dtype: so does this head."""

    def __init__(self, dim_embedding: int, dim_feedforward: int, dim_x: int,
                 time_token: bool = False, log_std_min: float = -20.0,
                 log_std_max: float = 2.0, device=None):
        super().__init__()
        self.time_token = time_token
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        d_in = dim_embedding + int(time_token)
        self.mean_predictor_fc1 = nn.Linear(d_in, dim_feedforward,
                                            device=device)
        self.mean_predictor_fc2 = nn.Linear(dim_feedforward, dim_x,
                                            device=device)
        self.log_std_predictor_fc1 = nn.Linear(d_in, dim_feedforward,
                                               device=device)
        self.log_std_predictor_fc2 = nn.Linear(dim_feedforward, dim_x,
                                               device=device)
        init_dense_(self)

    def forward(self, z: torch.Tensor, t: Optional[torch.Tensor] = None):
        if self.time_token:
            z = _with_time(z, t)
        z = z.float()
        mean = self.mean_predictor_fc2(torch.relu(self.mean_predictor_fc1(z)))
        log_std = self.log_std_predictor_fc2(
            torch.relu(self.log_std_predictor_fc1(z)))
        log_std = torch.clamp(log_std, self.log_std_min, self.log_std_max)
        return mean, torch.exp(log_std)


class ValueHead(nn.Module):
    """Critic: the mean over context tokens of a per-token MLP value
    (computed in ``dtype``, read in float32); a batch row without context
    takes the learned ``empty_value``."""

    def __init__(self, dim_embedding: int, dim_feedforward: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.empty_value = nn.Parameter(torch.zeros(1, device=device))
        self.predictor_fc1 = Dense(dim_embedding, dim_feedforward, dtype,
                                   device)
        self.predictor_fc2 = Dense(dim_feedforward, 1, dtype, device)
        init_dense_(self)

    def forward(self, z_points: torch.Tensor,
                ctx_mask: torch.Tensor) -> torch.Tensor:
        v = self.predictor_fc2(torch.relu(self.predictor_fc1(z_points)))
        v = v[..., 0].float()                                # [B, P]
        w = ctx_mask.to(v.dtype)
        count = torch.sum(w, dim=1)
        mean_v = torch.sum(v * w, dim=1) / torch.clamp(count, min=1.0)
        return torch.where(count > 0, mean_v, self.empty_value[0])


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

    ``single_head``: one MLP (``fc1``, ``fc2``) emits all 3·C outputs,
    grouped as C means, C raw stds, C raw weights; no kernel.
    """

    def __init__(self, dim_embedding: int, dim_feedforward: int,
                 num_components: int, std_min: float = 1e-4, device=None,
                 *, dtype=torch.float32, fused: str = "auto",
                 single_head: bool = False):
        super().__init__()
        if fused not in ("auto", "on", "off"):
            raise ValueError(f"fused_gmm={fused!r}; one of auto, on, off")
        C, D, Fd = num_components, dim_embedding, dim_feedforward
        self.std_min = std_min
        self.dtype = dtype
        self.fused = fused
        self.single_head = single_head
        if single_head:
            self.fc1 = Dense(D, Fd, dtype, device)
            self.fc2 = Dense(Fd, 3 * C, dtype, device)
            init_dense_(self)
            return
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
        if self.single_head:
            out = self.fc2(torch.relu(self.fc1(z))).float()
            out = out.reshape(z.shape[:-1] + (3, -1)).transpose(-1, -2)
        elif self.use_kernel(z.shape[1]):
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
    design from the pool and predicts both posteriors (and, with
    ``value_head``, the critic's value)."""

    def __init__(self, dim_embedding: int, dim_feedforward: int,
                 num_components: int = 10, std_min: float = 1e-4,
                 time_token: bool = False, device=None, *,
                 dtype=torch.float32, fused_gmm: str = "auto",
                 single_head: bool = False, value_head: bool = False):
        super().__init__()
        self.acquisition_head = AcquisitionHead(
            dim_embedding, dim_feedforward, time_token, dtype, device)
        self.target_head = GMMTargetHead(dim_embedding, dim_feedforward,
                                         num_components, std_min, device,
                                         dtype=dtype, fused=fused_gmm,
                                         single_head=single_head)
        self.value_head = (ValueHead(dim_embedding, dim_feedforward, dtype,
                                     device) if value_head else None)

    def forward(self, batch: Batch, z: torch.Tensor, *, training: bool,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                query_posterior: bool = True,
                time_offset: int = 0) -> AlineOutput:
        """``z`` is the encoder output [B, time? + n_points + n_target, D];
        ``time_offset`` is 1 when a time token leads it.  ``training``
        draws the design by Gumbel-max, as
        ``jax.random.categorical`` does: argmax of the logits plus
        ``noise`` [B, n_points] standard Gumbel noise, drawn from
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
            if noise is None:
                noise = gumbel_noise(logits.shape, generator)
            idx = torch.argmax(logits + noise, dim=-1)
        else:
            idx = torch.argmax(log_probs, dim=-1)
        b = torch.arange(z.shape[0], device=z.device)
        zt = torch.where(pool, log_probs.exp(),
                         torch.zeros((), device=z.device))
        return AlineOutput(
            design_out=DesignOut(idx=idx, log_prob=log_probs[b, idx], zt=zt),
            posterior_out=self.target_head(z_target),
            posterior_out_query=(self.target_head(z_points)
                                 if query_posterior else None),
            value=(self.value_head(z_points, batch.ctx_mask)
                   if self.value_head is not None else None))


class ContinuousOutputHead(nn.Module):
    """The Gaussian-policy head of continuous designs: reads the query
    slot, the last point slot of the continuous batch layout
    (``train/continuous.py``), and emits a design from it."""

    def __init__(self, dim_x: int, dim_embedding: int, dim_feedforward: int,
                 num_components: int = 10, std_min: float = 1e-4,
                 time_token: bool = False, device=None, *,
                 dtype=torch.float32, fused_gmm: str = "auto",
                 single_head: bool = False, log_std_min: float = -20.0,
                 log_std_max: float = 2.0):
        super().__init__()
        self.acquisition_head = ContinuousAcquisitionHead(
            dim_embedding, dim_feedforward, dim_x, time_token, log_std_min,
            log_std_max, device)
        self.target_head = GMMTargetHead(dim_embedding, dim_feedforward,
                                         num_components, std_min, device,
                                         dtype=dtype, fused=fused_gmm,
                                         single_head=single_head)

    def forward(self, batch: Batch, z: torch.Tensor, *, training: bool,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                query_posterior: bool = True,
                time_offset: int = 0) -> AlineOutput:
        """``training``: xi = mean + std · ``noise`` ([B, 1, dim_x]
        standard normal, drawn from ``generator`` when not given);
        otherwise xi = mean.  The log-prob is taken from (xi - mean) / std,
        as JAX takes it.  ``query_posterior=False`` skips the query
        token's posterior, which the rollout does not read."""
        n_points = batch.n_points
        z_points = z[:, time_offset:time_offset + n_points]
        z_target = z[:, time_offset + n_points:]
        z_query = z_points[:, -1:]
        mean, std = self.acquisition_head(z_query, batch.t)  # [B, 1, dim_x]
        if training:
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator,
                                    device=mean.device)
            xi = mean + std * noise
        else:
            xi = mean
        z_norm = (xi - mean) / std
        lp = -0.5 * z_norm ** 2 - torch.log(std) - 0.5 * _LOG_2PI_F32
        return AlineOutput(
            design_out=ContinuousDesignOut(xi=xi, log_prob=lp.sum(-1)[:, 0],
                                           mean=mean, std=std),
            posterior_out=self.target_head(z_target),
            posterior_out_query=(self.target_head(z_query)
                                 if query_posterior else None))


def gumbel_noise(shape, generator: Optional[torch.Generator]
                 ) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in (0, 1), on
    the generator's device."""
    device = generator.device if generator is not None else None
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))
