"""The training loop (``aline_tpu/train/loop.py``): the burning-phase
schedule, one rollout + REINFORCE/NLL step + clipped AdamW update per
epoch, logging and checkpoints.  The model computes in the run's dtype
(``models.aline.compute_dtype``); the parameters, AdamW and the loss stay
float32, as in ``aline_tpu``.

JAX compiles the whole step into one program per (phase, T, mask
variant); here each step runs eagerly, so no step cache is kept.  The
host streams follow JAX's order, so that a seed gives JAX's sequence of
(phase, T, mask): ``T`` is drawn from the host ``random.Random`` first,
then the mask.  The GP batch and the design noise come from a
``torch.Generator`` on the run's device, whose draws differ from JAX's.
"""
from __future__ import annotations

import os
import random as pyrandom
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from aline_tpu_torch.config import Config
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.models.heads import gumbel_noise
from aline_tpu_torch.ops.target_mask import (
    create_target_mask,
    target_weight_vectors,
)
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.tasks.base import Batch, init_ctx_idx
from aline_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from aline_tpu_torch.train.loss import total_loss
from aline_tpu_torch.train.optimizer import (
    build_optimizer,
    clip_by_inf_norm,
    phase_for_epoch,
)
from aline_tpu_torch.train.rollout import rollout
from aline_tpu_torch.utils.device import resolve_device
from aline_tpu_torch.utils.logging import create_logger
from aline_tpu_torch.utils.serialization import save_params_npz


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all ``tensors`` taken together."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def train_step(model, optimizer, scheduler, batch: Batch, T: int,
               w_query: torch.Tensor, w_pred: torch.Tensor, alpha: float,
               gumbel: Optional[torch.Tensor], *, gamma: float,
               clip_grads: bool = True, use_remat: bool = True,
               sel_targets: Optional[tuple] = None, time_token: bool = False
               ) -> Dict[str, torch.Tensor]:
    """One update: rollout → loss → backward → inf-norm clip → AdamW.

    ``gumbel`` [T, B, n_points] draws the designs (None: greedy).  Returns
    the loss metrics with ``grad_norm`` (global L2, before the clip) and
    ``param_norm`` (after the update), as device scalars.
    """
    ro = rollout(model, batch, T, w_query, w_pred, gumbel,
                 time_token=time_token, use_remat=use_remat,
                 sel_targets=sel_targets)
    loss, m = total_loss(ro, gamma, alpha)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = list(model.parameters())
    m["grad_norm"] = global_norm([p.grad for p in params])
    if clip_grads:
        clip_by_inf_norm(params, 1.0)
    optimizer.step()
    scheduler.step()
    with torch.no_grad():
        m["param_norm"] = global_norm(params)
    return {k: v.detach() for k, v in m.items()}


def check_supported(cfg: Config) -> None:
    """Refuse, by name, the settings this port does not train with."""
    refused = {
        "encoder.dropout > 0 (dropout is not ported yet)":
            cfg.encoder.dropout > 0,
        "eval.EIG=true (the EIG bounds are not ported yet)": cfg.eval.EIG,
        "mesh_data > 1 (the port trains on one device)": cfg.mesh_data > 1,
        "remat_policy other than 'full' (not ported yet)":
            cfg.remat_policy != "full",
        "profile_dir (use scripts/profile_torch_train.py)":
            cfg.profile_dir is not None,
        "debug_nans=true (not ported yet)": cfg.debug_nans,
    }
    bad = [what for what, hit in refused.items() if hit]
    if bad:
        raise NotImplementedError("the PyTorch trainer refuses: "
                                  + "; ".join(bad))


class Trainer:
    """Owns the model, task, optimizer and RNG streams; runs the epochs.

    The model is initialised on the CPU from ``cfg.seed`` (so a seed gives
    the same initial weights on every device) and moved to ``device``.
    """

    def __init__(self, cfg: Config, logger=None, device="cuda",
                 model: Optional[torch.nn.Module] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = logger or create_logger(
            os.path.join(cfg.output_dir, "logs"),
            name=cfg.task.name or "aline")
        self.task = build_task(cfg.task)
        seed = cfg.seed if cfg.fix_seed else None
        self.pyrng = pyrandom.Random(seed)
        # aline_tpu draws from numpy only for HPO tasks; kept so that
        # checkpoints carry the same streams
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
        self._sel_variants: set = set()
        self._sel_disabled = not cfg.static_mask_keys
        self.optimizer = self.scheduler = None
        self.phase: Optional[str] = None
        self.start_epoch = 0

    # -- plumbing ----------------------------------------------------------
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

    def save(self, epoch: int, path: Optional[str] = None) -> str:
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
        cfg = self.cfg
        phase = phase_for_epoch(cfg, epoch)
        if phase != self.phase:
            if self.phase == "burning":
                # burning→main: snapshot, then a fresh optimizer
                path = save_params_npz(self.model_path("_burning"),
                                       self.model)
                self.logger.info(f"Burning snapshot saved at {path}")
            self._ensure_phase(phase)

        T = self.pyrng.randint(cfg.min_T, cfg.T)
        # burning shrinks the query pool to T
        n_query = cfg.T if phase == "burning" else cfg.task.n_query_init
        batch = self.task.sample_batch(self.gen, cfg.batch_size, n_query)
        mask, w_q, w_p = self._epoch_mask_and_weights()
        batch = batch.replace(
            target_mask=torch.from_numpy(mask).to(self.device))
        batch = init_ctx_idx(
            batch, min(self.task.n_context_init + T, batch.n_points))
        gumbel = gumbel_noise((T, batch.batch_size, batch.n_points),
                              self.gen)
        alpha = 0.0 if phase == "burning" else cfg.alpha
        m = train_step(
            self.model, self.optimizer, self.scheduler, batch, T,
            torch.from_numpy(w_q).to(self.device),
            torch.from_numpy(w_p).to(self.device), alpha, gumbel,
            gamma=cfg.gamma, clip_grads=cfg.clip_grads,
            use_remat=cfg.rollout_remat, sel_targets=self._static_sel(mask),
            time_token=cfg.time_token)
        m["T"] = T
        return m

    def train(self, tracker=None):
        """The epochs from ``start_epoch`` to ``cfg.max_epoch``; returns
        the host time of each epoch (work is queued on the device, so an
        epoch's time is only whole at the ``verbose`` sync points)."""
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
        for epoch in range(self.start_epoch, cfg.max_epoch):
            t0 = time.perf_counter()
            m = self.train_epoch(epoch)
            epoch_times.append(time.perf_counter() - t0)
            if epoch % cfg.verbose == 0:
                m = {k: float(v) for k, v in m.items()}     # sync point
                if tracker is not None:
                    tracker.log(m, step=epoch)
                self.logger.info(
                    f"Epoch: {epoch}, loss: {m['loss']:.4f}, T: {m['T']}, "
                    f"likelihood: {m['likelihood']:.4f}, design_loss: "
                    f"{m['design_loss']:.4f}, predict_loss: "
                    f"{m['predict_loss']:.4f}")
            next_epoch = epoch + 1
            if cfg.checkpoint and next_epoch % cfg.checkpoint == 0:
                self.save(next_epoch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        total = time.perf_counter() - wall_start
        n = max(len(epoch_times), 1)
        self.logger.info(
            f"Total training time: {total:.2f}s ({total / 3600:.2f}h), "
            f"average wall time per epoch: {total / n:.4f}s")
        return epoch_times
