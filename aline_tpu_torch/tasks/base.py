"""Task protocol and the static-shape experiment batch
(``aline_tpu/tasks/base.py``).

The batch keeps one fixed ``[B, n_points, ...]`` buffer of candidate
points for the whole rollout and flips a per-point context flag:
``ctx_mask[b, i]`` is True once point i is context (its y revealed), and
False while it is still in the query pool.  Selecting a design is one
index-put into ``ctx_mask``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Batch:
    """One batch of experiments with static shapes.

    Attributes:
        x:           [B, n_points, dim_x] candidate design points (initial
                     context first, then the query pool).
        y:           [B, n_points, dim_y] pre-simulated outcomes.
        ctx_mask:    [B, n_points] bool; True = currently context.
        target_x:    [B, n_target_data, dim_x] target input locations.
        target_all:  [B, n_target, 1] ground truth the posterior head is
                     scored on: target_y ++ theta.
        theta:       task-natural latent ([B, dim_x+1, 1] for the GP).
        target_mask: [n_target] bool selected targets.
        t:           [] float32 time-token scalar.
        ctx_capacity: static bound on the context size for the rollout;
                     positive enables the compact attention path.
        ctx_idx:     optional [B, ctx_capacity] int64 indices of context
                     points in acquisition order (padded).
    """
    x: torch.Tensor
    y: torch.Tensor
    ctx_mask: torch.Tensor
    target_x: torch.Tensor
    target_all: torch.Tensor
    theta: torch.Tensor
    target_mask: torch.Tensor
    t: torch.Tensor
    ctx_capacity: int = 0
    ctx_idx: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.x.shape[0]

    @property
    def n_points(self) -> int:
        return self.x.shape[1]

    @property
    def n_target_data(self) -> int:
        return self.target_x.shape[1]

    @property
    def n_target(self) -> int:
        return self.target_all.shape[1]

    @property
    def query_mask(self) -> torch.Tensor:
        """[B, n_points] bool — points still available for acquisition."""
        return ~self.ctx_mask

    def replace(self, **changes) -> "Batch":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "Batch":
        return self.replace(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


_INT_FIELDS = ("ctx_idx",)
_BOOL_FIELDS = ("ctx_mask", "target_mask")


def batch_from_numpy(src, device="cpu") -> Batch:
    """A Batch from any object whose Batch-named attributes convert with
    ``np.asarray`` (e.g. a batch another framework drew)."""
    fields = {}
    for f in dataclasses.fields(Batch):
        v = getattr(src, f.name)
        if f.name == "ctx_capacity":
            fields[f.name] = int(v)
            continue
        if v is None:
            fields[f.name] = None
            continue
        a = np.asarray(v)
        if f.name in _INT_FIELDS:
            a = a.astype(np.int64)
        elif f.name in _BOOL_FIELDS:
            a = a.astype(bool)
        else:
            a = a.astype(np.float32)
        fields[f.name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Batch(**fields)


def select_design(batch: Batch, idx: torch.Tensor
                  ) -> Tuple[Batch, torch.Tensor, torch.Tensor]:
    """Move the chosen query points ``idx`` [B] into the context.

    Returns (updated batch, chosen x [B, dim_x], chosen y [B, dim_y]).
    """
    b = torch.arange(batch.batch_size, device=idx.device)
    new_ctx = batch.ctx_mask.clone()
    new_ctx[b, idx] = True
    new_ctx_idx = batch.ctx_idx
    if new_ctx_idx is not None:
        count = batch.ctx_mask.sum(dim=1)
        slot = torch.clamp(count, max=new_ctx_idx.shape[1] - 1)
        new_ctx_idx = new_ctx_idx.clone()
        new_ctx_idx[b, slot] = idx.to(new_ctx_idx.dtype)
    return (batch.replace(ctx_mask=new_ctx, ctx_idx=new_ctx_idx),
            batch.x[b, idx], batch.y[b, idx])


def init_ctx_idx(batch: Batch, capacity: int) -> Batch:
    """Attach the context index buffer and capacity to a batch whose
    context is its first points (the layout every task produces)."""
    idx = torch.arange(capacity, device=batch.x.device)[None].expand(
        batch.batch_size, capacity).contiguous()
    return batch.replace(ctx_capacity=capacity, ctx_idx=idx)


class Task:
    """Base simulator: design-space conventions and batch packing.

    Subclasses implement ``sample_theta(gen, shape)`` (latent draws from
    the prior), ``simulate(gen, x, theta)`` (outcomes at designs x in the
    real design space), ``log_likelihood(y, xi, theta)`` (pointwise
    log p(y | xi, theta), broadcasting over a leading contrastive axis)
    and ``sample_batch(gen, batch_size, n_query=None)``.  Every draw comes
    from the explicit ``torch.Generator`` ``gen``, on its device.
    """

    def __init__(self, cfg):
        self.cfg = cfg
        self.name = cfg.name
        self.dim_x = cfg.dim_x
        self.dim_y = cfg.dim_y
        self.embedding_type = cfg.embedding_type
        self.n_context_init = cfg.n_context_init
        self.n_query_init = cfg.n_query_init
        self.n_target_data = (cfg.n_target_data
                              if cfg.embedding_type in ("data", "mix") else 0)
        self.n_target_theta = (cfg.n_target_theta
                               if cfg.embedding_type in ("theta", "mix")
                               else 0)
        self.design_scale = float(cfg.design_scale)

    # -- design space ------------------------------------------------------
    def to_design_space(self, xi):
        return xi * self.design_scale

    def normalise_design(self, x):
        return x / self.design_scale

    def unnormalise_design(self, x):
        return x * self.design_scale

    def normalise_outcomes(self, y):
        return y

    # -- abstract ----------------------------------------------------------
    def sample_theta(self, gen: torch.Generator, shape: Tuple[int, ...]):
        raise NotImplementedError

    def simulate(self, gen: torch.Generator, x: torch.Tensor,
                 theta) -> torch.Tensor:
        raise NotImplementedError

    def log_likelihood(self, y, xi, theta):
        raise NotImplementedError

    def sample_batch(self, gen: torch.Generator, batch_size: int,
                     n_query: Optional[int] = None) -> Batch:
        raise NotImplementedError

    def _initial_ctx_mask(self, batch_size: int, n_points: int,
                          device) -> torch.Tensor:
        m = torch.zeros(batch_size, n_points, dtype=torch.bool,
                        device=device)
        m[:, :self.n_context_init] = True
        return m

    def _pack_batch(self, x, y, target_x, target_y, theta_tokens,
                    theta, embedding_type: Optional[str] = None) -> Batch:
        """Assemble a Batch with the mode's ``target_all``: the task's
        embedding type, or ``embedding_type`` where given."""
        B, dev = x.shape[0], x.device
        embedding_type = embedding_type or self.embedding_type
        if embedding_type == "theta":
            target_all = theta_tokens
            target_x = torch.zeros(B, 0, self.dim_x, dtype=x.dtype,
                                   device=dev)
        elif embedding_type == "data":
            target_all = target_y
        else:  # mix
            target_all = torch.cat([target_y, theta_tokens], dim=1)
        return Batch(
            x=x, y=y,
            ctx_mask=self._initial_ctx_mask(B, x.shape[1], dev),
            target_x=target_x,
            target_all=target_all,
            theta=theta,
            target_mask=torch.ones(target_all.shape[1], dtype=torch.bool,
                                   device=dev),
            t=torch.zeros((), dtype=torch.float32, device=dev),
        )
