"""The training loop (``aline_tpu/train/loop.py``): the burning-phase
schedule, one rollout + REINFORCE/NLL step + clipped AdamW update per
epoch, logging and checkpoints.  The model computes in the run's dtype
(``models.aline.compute_dtype``); the parameters, AdamW and the loss stay
float32, as in ``aline_tpu``.

JAX compiles the whole step into one program per (phase, T, mask
variant).  Here, on the card, the rollout's forward and backward are
CUDA graphs, one pair per such key, captured on the key's second epoch
and replayed from then on (``train/graph.py``, the name ``rollout``
below); the loss, the data axis's all-reduce, the clip and AdamW run
eagerly.  On the CPU and under ``debug_nans`` every step runs eagerly.
The host streams follow JAX's order, so that a seed gives JAX's sequence
of (phase, T, mask): ``T`` is drawn from the host ``random.Random``
first, then the mask.  The simulated tasks' batches and the design noise come
from a ``torch.Generator`` on the run's device, whose draws differ from
JAX's; the HPO task's batches from the host numpy ``Generator`` of the
seed, as JAX's do, so they are JAX's bit for bit.

Data parallelism (``mesh_data``, ``aline_tpu/train/loop.py``): every
rank of a ``torch.distributed`` process group draws the WHOLE batch, the
epoch's mask and the [T, B, n_points] design noise from the same streams
and keeps its block of rows, so a seed gives the same global batch at any
world size, as JAX draws and then shards.  The reward is normalised over
the global batch (``train/loss.py``); after the backward pass one
all-reduce of a flat buffer of every gradient (SUM, then / n) gives each
rank the global mean gradient, on which the norm, the clip and AdamW act
alike: the parameters stay bitwise equal on every rank.  Rank 0 alone
writes the checkpoints, the burning snapshot, the log file, the tracker
and runs the EIG hook; every rank restores the same checkpoint, and a run
saved at one world size resumes at another.
"""
from __future__ import annotations

import contextlib
import os
import random as pyrandom
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from aline_tpu_torch.config import Config
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.models.heads import gumbel_noise
from aline_tpu_torch.ops.target_mask import (
    create_target_mask,
    target_weight_vectors,
)
from aline_tpu_torch.parallel.collectives import all_reduce
from aline_tpu_torch.parallel.mesh import (
    get_mesh,
    get_rank,
    shard_leading_axis,
    world_size,
)
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.base import Batch, init_ctx_idx
from aline_tpu_torch.tasks.hpo import HPOTask
from aline_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from aline_tpu_torch.train.loss import total_loss
from aline_tpu_torch.train.optimizer import (
    build_optimizer,
    clip_by_inf_norm,
    phase_for_epoch,
)
from aline_tpu_torch.train.graph import rollout
from aline_tpu_torch.utils.debug import guard_active, nan_guard
from aline_tpu_torch.utils.device import resolve_device
from aline_tpu_torch.utils.logging import create_logger
from aline_tpu_torch.utils.metrics import (
    Metrics,
    PhaseTimer,
    profiler_trace,
    span,
)
from aline_tpu_torch.utils.serialization import save_params_npz

# the Batch fields with a leading batch axis, split over the data axis
ROW_FIELDS = ("x", "y", "ctx_mask", "target_x", "target_all", "theta",
              "ctx_idx")


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all ``tensors`` taken together."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def mean_over_ranks(tensors, group, n_ranks: int):
    """Each tensor replaced, in place, by its mean over the ``n_ranks``
    ranks of ``group``: one all-reduce of one flat buffer (SUM, / n)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n_ranks
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def train_step(model, optimizer, scheduler, batch: Batch, T: int,
               w_query: torch.Tensor, w_pred: torch.Tensor, alpha: float,
               gumbel: Optional[torch.Tensor], *, gamma: float,
               clip_grads: bool = True, use_remat: bool = True,
               remat_policy: str = "full",
               sel_targets: Optional[tuple] = None, time_token: bool = False,
               group=None, n_ranks: int = 1) -> Dict[str, torch.Tensor]:
    """One update: rollout → loss → backward → inf-norm clip → AdamW.

    ``gumbel`` [T, B, n_points] draws the designs (None: greedy).
    ``group`` of ``n_ranks`` ranks: the data axis, each rank holding its
    rows of ``batch`` and ``gumbel``; the reward is normalised over the
    global batch, and the gradients and the loss metrics are the global
    means.  Returns the loss metrics with ``grad_norm`` (global L2, before
    the clip) and ``param_norm`` (after the update), as device scalars.
    """
    with span("train.rollout"):
        ro = rollout(model, batch, T, w_query, w_pred, gumbel,
                     time_token=time_token, use_remat=use_remat,
                     remat_policy=remat_policy, sel_targets=sel_targets)
    with span("train.loss"):
        loss, m = total_loss(ro, gamma, alpha, group, n_ranks)
    params = list(model.parameters())
    with span("train.backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            mean_over_ranks([p.grad for p in params], group, n_ranks)
            names = list(m)
            means = all_reduce(torch.stack([m[k].detach() for k in names]),
                               group=group) / n_ranks
            m = dict(zip(names, means.unbind()))
    with span("train.optimizer"):
        m["grad_norm"] = global_norm([p.grad for p in params])
        if clip_grads:
            clip_by_inf_norm(params, 1.0)
        optimizer.step()
        scheduler.step()
        with torch.no_grad():
            m["param_norm"] = global_norm(params)
    return {k: v.detach() for k, v in m.items()}


def check_supported(cfg: Config) -> None:
    """Refuse, by name, the one setting this port does not train with:
    dropout, which the JAX encoder never applies either."""
    if cfg.encoder.dropout > 0:
        raise NotImplementedError("the PyTorch trainer refuses: "
                                  "encoder.dropout > 0 (dropout is not "
                                  "ported yet)")


class Trainer:
    """Owns the model, task, optimizer and RNG streams; runs the epochs.

    The model is initialised on the CPU from ``cfg.seed`` (so a seed gives
    the same initial weights on every device and rank) and moved to
    ``device``.  Under a ``torch.distributed`` process group the first
    ``mesh_data`` ranks (0: all) form the data axis (module docstring); a
    ``batch_size`` that the axis does not divide trains every row on every
    rank, as JAX falls back to one device.
    """

    def __init__(self, cfg: Config, logger=None, device="cuda",
                 model: Optional[torch.nn.Module] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rank = get_rank()
        self.is_writer = self.rank == 0
        self.logger = logger or create_logger(
            os.path.join(cfg.output_dir, "logs") if self.is_writer else None,
            name=cfg.task.name or "aline")
        self.metrics = Metrics()
        self.timer = PhaseTimer(self.device, span_prefix="train.")
        self._init_data_axis()
        self.task = build_task(cfg.task)
        seed = cfg.seed if cfg.fix_seed else None
        self.pyrng = pyrandom.Random(seed)
        # the HPO task's batches come from numpy on the host, as in
        # aline_tpu: the same seed gives the JAX trainer's batches
        self.nprng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=self.device)
        if seed is None:
            self.gen.seed()
        else:
            self.gen.manual_seed(seed)
        if model is None:
            with torch.random.fork_rng(devices=[]):
                torch.default_generator.manual_seed(cfg.seed)
                model = build_model(cfg, "cpu")
        self.model = model.to(self.device).train()
        if isinstance(self.task, HPOTask):
            # aline_tpu initialises its parameters on a batch of 2 drawn
            # here; the port draws it too, so the streams stay aligned
            self.task.sample_batch(self.nprng, 2,
                                   min(4, cfg.task.n_query_init))
        self._sel_variants: set = set()
        self._sel_disabled = not cfg.static_mask_keys
        self.optimizer = self.scheduler = None
        self.phase: Optional[str] = None
        self.start_epoch = 0

    # -- plumbing ----------------------------------------------------------
    def _init_data_axis(self):
        """The data axis: ``n_data`` ranks, this rank's ``data_index`` and
        process group; ``active`` is False on ranks beyond it."""
        n_world = world_size()
        want = self.cfg.mesh_data if self.cfg.mesh_data > 0 else n_world
        if self.cfg.batch_size % want != 0:
            self.logger.warning(
                f"batch_size {self.cfg.batch_size} not divisible by {want} "
                f"devices; training on a single device (every rank trains "
                f"the whole batch)")
            want = 1
        self.mesh = get_mesh(want) if want > 1 else None
        self.n_data = want
        self.active = self.mesh is None or self.mesh.member
        self.data_index = self.mesh.index("data") if (
            self.mesh is not None and self.active) else 0
        self.data_group = (self.mesh.group("data")
                           if self.mesh is not None else None)
        if not self.active:
            self.logger.info(f"rank {self.rank} takes no part: mesh_data="
                             f"{want} of {n_world} ranks")

    def _shard(self, batch: Batch, gumbel: torch.Tensor):
        """This rank's rows of the batch and of the [T, B, n] noise."""
        if self.n_data == 1:
            return batch, gumbel
        rows = shard_leading_axis(
            {f: getattr(batch, f) for f in ROW_FIELDS
             if getattr(batch, f) is not None}, self.mesh)
        m = batch.batch_size // self.n_data
        i = self.data_index
        return batch.replace(**rows), gumbel[:, i * m:(i + 1) * m]

    def _ensure_phase(self, phase: str):
        if phase != self.phase:
            self.optimizer, self.scheduler = build_optimizer(
                self.cfg, self.model, phase)
            self.phase = phase

    def _static_sel(self, mask) -> Optional[Tuple[int, ...]]:
        """The static key-set variant for this epoch's mask, or None
        (``aline_tpu`` ``Trainer._static_sel``): the compact attention
        drops the never-visible target key columns (exact).  Off once the
        task has produced more than ``static_mask_keys_max`` masks."""
        if self._sel_disabled or self.cfg.encoder.attention_impl not in (
                "auto", "compact"):
            return None
        sel = tuple(int(i) for i in np.flatnonzero(mask))
        if len(sel) == len(mask):
            return None
        self._sel_variants.add(sel)
        if len(self._sel_variants) > self.cfg.static_mask_keys_max:
            self._sel_disabled = True
            self.logger.info("static_mask_keys: >%d distinct masks; using "
                             "every target column from now on"
                             % self.cfg.static_mask_keys_max)
            return None
        return sel

    def _epoch_mask_and_weights(self):
        tc = self.cfg.task
        mask_type = self.pyrng.choice(list(tc.mask_type))
        mask = create_target_mask(
            mask_type, tc.embedding_type, self.task.n_target_data,
            self.task.n_target_theta, tc.n_selected_targets,
            tc.predefined_masks, tc.predefined_mask_weights, tc.mask_index,
            tc.attend_to, rng=self.pyrng)
        w_q, w_p = target_weight_vectors(
            mask, tc.embedding_type, mask_type, self.task.n_target_data,
            self.task.n_target_theta)
        return mask, w_q, w_p

    # -- checkpoints -------------------------------------------------------
    def _ckpt_path(self) -> str:
        stem = self.cfg.checkpoint_name.split(".")[0]
        return os.path.join(self.cfg.output_dir, f"{stem}.pt")

    def model_path(self, suffix: str = "") -> str:
        stem = self.cfg.file_name.split(".")[0]
        return os.path.join(self.cfg.output_dir, "model",
                            f"{stem}{suffix}.npz")

    def save(self, epoch: int, path: Optional[str] = None) -> Optional[str]:
        """Write the checkpoint (rank 0 alone; None elsewhere)."""
        if not self.is_writer:
            return None
        return save_checkpoint(path or self._ckpt_path(), dict(
            epoch=epoch, phase=self.phase,
            model=self.model.state_dict(),
            optimizer=self.optimizer.state_dict(),
            scheduler=self.scheduler.state_dict(),
            generator=self.gen.get_state(),
            pyrandom=self.pyrng.getstate(),
            numpy=self.nprng.bit_generator.state))

    def restore(self, path: Optional[str] = None):
        """Resume from a checkpoint: the phase's optimizer is rebuilt and
        every state, the RNG streams included, is loaded back."""
        path = path or self._ckpt_path()
        state = load_checkpoint(path)
        self.model.load_state_dict(state["model"])
        self.phase = None
        self._ensure_phase(state["phase"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.gen.set_state(state["generator"])
        self.pyrng.setstate(state["pyrandom"])
        self.nprng.bit_generator.state = state["numpy"]
        self.start_epoch = state["epoch"]
        self.logger.info(f"Restored checkpoint from {path} at epoch "
                         f"{self.start_epoch}")

    # -- training ----------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, torch.Tensor]:
        with span("train.epoch"):
            cfg = self.cfg
            phase = phase_for_epoch(cfg, epoch)
            if phase != self.phase:
                if self.phase == "burning" and self.is_writer:
                    # burning→main: snapshot, then a fresh optimizer
                    path = save_params_npz(self.model_path("_burning"),
                                           self.model)
                    self.logger.info(f"Burning snapshot saved at {path}")
                self._ensure_phase(phase)

            T = self.pyrng.randint(cfg.min_T, cfg.T)
            # burning shrinks the query pool to T
            n_query = (cfg.T if phase == "burning"
                       else cfg.task.n_query_init)
            with self.timer.phase("sample"):
                # the whole batch on every rank, then this rank's rows
                if isinstance(self.task, HPOTask):
                    batch = self.task.sample_batch(
                        self.nprng, cfg.batch_size, n_query,
                        device=self.device)
                else:
                    batch = self.task.sample_batch(self.gen, cfg.batch_size,
                                                   n_query)
                mask, w_q, w_p = self._epoch_mask_and_weights()
                batch = batch.replace(
                    target_mask=torch.from_numpy(mask).to(self.device))
                batch = init_ctx_idx(batch, min(self.task.n_context_init + T,
                                                 batch.n_points))
                gumbel = gumbel_noise(
                    (T, batch.batch_size, batch.n_points), self.gen)
                batch, gumbel = self._shard(batch, gumbel)
            alpha = 0.0 if phase == "burning" else cfg.alpha
            with self.timer.phase("step"):
                m = train_step(
                    self.model, self.optimizer, self.scheduler, batch, T,
                    torch.from_numpy(w_q).to(self.device),
                    torch.from_numpy(w_p).to(self.device), alpha, gumbel,
                    gamma=cfg.gamma, clip_grads=cfg.clip_grads,
                    use_remat=cfg.rollout_remat,
                    remat_policy=cfg.remat_policy,
                    sel_targets=self._static_sel(mask),
                    time_token=cfg.time_token, group=self.data_group,
                    n_ranks=self.n_data)
            m["T"] = T
            return m

    def train(self, eval_hook=None, tracker=None):
        """The epochs from ``start_epoch`` to ``cfg.max_epoch``; returns
        the host time of each epoch (work is queued on the device, so an
        epoch's time is only whole at the ``verbose`` sync points).  A
        rank beyond the data axis returns at once.

        ``eval_hook``: optional callable(trainer, epoch) → dict of bounds,
        run on rank 0 every ``verbose`` epochs when ``cfg.eval.EIG``; its
        numbers go to the tracker and the log.  ``cfg.profile_dir``: a
        ``torch.profiler`` trace of epochs ``start + 2`` to ``start + 2 +
        profile_epochs`` (each under ``epoch_<n>``) is written there as
        ``trace_rank<r>.json``.  ``cfg.debug_nans``: the run under the NaN
        guard (``utils/debug.py``)."""
        if not self.active:
            return []
        with nan_guard(self.cfg.debug_nans and not guard_active()):
            return self._train(eval_hook, tracker)

    def _train(self, eval_hook, tracker):
        cfg = self.cfg
        self._ensure_phase(phase_for_epoch(cfg, self.start_epoch))
        if cfg.load_checkpoint:
            path = cfg.load_path or self._ckpt_path()
            if os.path.exists(path):
                self.restore(path)
            else:
                # resume-if-present: a fresh output dir starts from scratch
                self.logger.info(f"No checkpoint at {path}; starting fresh")

        wall_start = time.perf_counter()
        epoch_times = []
        trace = contextlib.ExitStack()
        profiling = False
        first = self.start_epoch + 2
        for epoch in range(self.start_epoch, cfg.max_epoch):
            if cfg.profile_dir is not None:
                # a few steady epochs, after the first ones' set-up
                if epoch == first:
                    trace.enter_context(profiler_trace(
                        cfg.profile_dir, f"trace_rank{self.rank}",
                        self.device))
                    profiling = True
                elif profiling and epoch == first + cfg.profile_epochs:
                    trace.close()
                    profiling = False
                    self.logger.info(
                        f"Profiler trace written to {cfg.profile_dir}")
            t0 = time.perf_counter()
            with (torch.profiler.record_function(f"epoch_{epoch}")
                  if profiling else contextlib.nullcontext()):
                m = self.train_epoch(epoch)
            epoch_times.append(time.perf_counter() - t0)
            if epoch % cfg.verbose == 0:
                m = {k: float(v) for k, v in m.items()}     # sync point
                self.metrics.log(**m)
                if tracker is not None and self.is_writer:
                    tracker.log(m, step=epoch)
                self.logger.info(
                    f"Epoch: {epoch}, loss: {m['loss']:.4f}, T: {m['T']}, "
                    f"likelihood: {m['likelihood']:.4f}, design_loss: "
                    f"{m['design_loss']:.4f}, predict_loss: "
                    f"{m['predict_loss']:.4f}")
                if cfg.eval.EIG and eval_hook is not None \
                        and self.is_writer:
                    bounds = eval_hook(self, epoch)
                    if tracker is not None:
                        tracker.log({k: v for k, v in bounds.items()
                                     if isinstance(v, (int, float))},
                                    step=epoch)
                    self.logger.info(f"PCE: {bounds.get('pce_mean')}\t"
                                     f"NMC: {bounds.get('nmc_mean')}")
            next_epoch = epoch + 1
            if cfg.checkpoint and next_epoch % cfg.checkpoint == 0:
                self.save(next_epoch)
        if profiling:
            trace.close()
            self.logger.info(f"Profiler trace written to {cfg.profile_dir}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        total = time.perf_counter() - wall_start
        n = max(len(epoch_times), 1)
        self.logger.info(
            f"Total training time: {total:.2f}s ({total / 3600:.2f}h), "
            f"average wall time per epoch: {total / n:.4f}s")
        self.logger.info("Phase times (host time to queue each phase's "
                         "work):\n%s", self.timer.summary())
        stream = self.timer.stream_summary()
        if stream:
            self.logger.info("Phase times on the stream (the spans' CUDA "
                             "events):\n%s", stream)
        return epoch_times
