"""Train the continuous-design ALINE variant on the card (the port of
``scripts/train_continuous.py``): the continuous embedder and the
Gaussian-policy head, wired by ``train/continuous.py``.

    python -m aline_tpu_torch.train_continuous max_epoch=5000 \
        burning_epoch=1000 output_dir=outputs/loc_continuous

Overrides are the run config's (``config.py``), after ``DEFAULTS``: the
location-finding recipe; ``device=cpu`` runs on the CPU.  The objective is
REINFORCE plus the prediction NLL (``train/loss.py``), plus
``alpha_pce`` times the pathwise sPCE loss over ``pce_L`` contrastive
thetas (the rollout is reparameterised end to end), which the burning
phase leaves out.  Burning and main phases take the two-phase AdamW of
``train/optimizer.py`` with its inf-norm clip.  Writes ``config.json``,
``metrics.jsonl`` (every ``verbose`` epochs), ``ckpt_cont.pt`` (every
``checkpoint`` epochs; ``load_checkpoint=true`` resumes from it bit for
bit; ``load_path=NPZ`` warm-starts the parameters only) and
``model/<file_name stem>.npz``.  With ``eval.EIG=true``, the final sPCE and
sNMC of greedy rollouts (``eval.M_final`` rows in batches of
``eval.batch_size_final``, ``eval.T_final`` steps, ``eval.L_final``
contrastive draws) go to ``continuous_bounds.npz``.
"""
from __future__ import annotations

import math
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from aline_tpu_torch.config import parse_overrides, save_config, to_dict, \
    to_yaml
from aline_tpu_torch.eval.eig import derive_seed, eval_eig_from_history
from aline_tpu_torch.eval.eig_losses import pce_loss
from aline_tpu_torch.models.aline import build_model
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from aline_tpu_torch.train.continuous import (
    draw_rollout_noise,
    make_continuous_batch,
    rollout_continuous,
)
from aline_tpu_torch.train.loss import total_loss
from aline_tpu_torch.train.optimizer import (
    build_optimizer,
    clip_by_inf_norm,
    phase_for_epoch,
)
from aline_tpu_torch.train.rollout import RolloutOutputs
from aline_tpu_torch.utils.device import resolve_device, split_device
from aline_tpu_torch.utils.serialization import (
    convert_flax_params,
    save_params_npz,
)
from aline_tpu_torch.utils.tracking import RunTracker

DEFAULTS = [
    "task=location_finding", "task.theta_dist=uniform",
    "task.n_target_theta=2", "task.K=1", "task.n_query_init=1",
    "lr=1e-3", "gamma=1", "min_T=30", "T=30", "batch_size=200",
    "max_epoch=5000", "burning_epoch=1000", "verbose=250",
    "embedder.continuous=true", "head.continuous=true",
    "output_dir=outputs/loc_continuous", "file_name=aline_cont.pth",
]


def target_weights(task, device) -> torch.Tensor:
    n_t = task.n_target_theta
    return torch.full((n_t,), 1.0 / n_t, device=device)


def continuous_loss(model, task, cfg, batch, design_noise, sim_noise,
                    contrastive: Optional[torch.Tensor], alpha: float,
                    design_on: float):
    """(loss, metrics) of one training rollout: REINFORCE with weight
    ``alpha`` plus the prediction NLL, plus ``design_on · alpha_pce ·``
    the sPCE loss on ``contrastive`` [pce_L, B, ...] thetas when
    ``cfg.alpha_pce > 0``."""
    w = target_weights(task, batch.x.device)
    ro = rollout_continuous(model, task, batch, cfg.T, w, w, sim_noise,
                            design_noise, training=True,
                            time_token=cfg.time_token,
                            use_remat=cfg.rollout_remat)
    loss, m = total_loss(RolloutOutputs(ro.log_probs, ro.nll_query,
                                        ro.nll_pred, None, ro.xs, ro.ys,
                                        None), cfg.gamma, alpha)
    m["policy_std"] = torch.mean(ro.stds)
    if cfg.alpha_pce > 0:
        xs = task.to_design_space(ro.xs.transpose(0, 1))     # [B, T, D]
        ys = ro.ys.transpose(0, 1)                           # [B, T, 1]
        thetas = torch.cat([batch.theta[None], contrastive], dim=0)
        l_pce = pce_loss(task, ys, xs, thetas)
        loss = loss + design_on * cfg.alpha_pce * l_pce
        m.update(loss=loss, pce_loss=l_pce,
                 spce_train=math.log(cfg.pce_L + 1.0) - l_pce)
    return loss, m


class ContinuousTrainer:
    """The model, task, generator and optimizer of a continuous run."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.task = build_task(cfg.task)
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(cfg.seed)
            model = build_model(cfg, "cpu")
        self.model = model.to(self.device).train()
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.optimizer = self.scheduler = self.phase = None
        self.start_epoch = 0

    def ensure_phase(self, phase: str) -> None:
        if phase != self.phase:
            self.optimizer, self.scheduler = build_optimizer(
                self.cfg, self.model, phase)
            self.phase = phase

    def draw(self, B: int):
        """One step's draws: the batch, both rollout noises and, with
        ``alpha_pce``, the contrastive thetas."""
        cfg, task = self.cfg, self.task
        batch = make_continuous_batch(task, self.gen, B, cfg.T)
        design_noise, sim_noise = draw_rollout_noise(task, self.gen, cfg.T,
                                                     B)
        contr = (task.sample_theta(self.gen, (cfg.pce_L, B))
                 if cfg.alpha_pce > 0 else None)
        return batch, design_noise, sim_noise, contr

    def train_epoch(self, epoch: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        self.ensure_phase(phase_for_epoch(cfg, epoch))
        burning = self.phase == "burning"
        loss, m = continuous_loss(
            self.model, self.task, cfg, *self.draw(cfg.batch_size),
            alpha=0.0 if burning else cfg.alpha,
            design_on=0.0 if burning else 1.0)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if cfg.clip_grads:
            clip_by_inf_norm(self.model.parameters(), 1.0)
        self.optimizer.step()
        self.scheduler.step()
        return {k: v.detach() for k, v in m.items()}

    # -- checkpoints -------------------------------------------------------
    def ckpt_path(self) -> str:
        return os.path.join(self.cfg.output_dir, "ckpt_cont.pt")

    def save(self, epoch: int) -> str:
        return save_checkpoint(self.ckpt_path(), dict(
            epoch=epoch, phase=self.phase, model=self.model.state_dict(),
            optimizer=self.optimizer.state_dict(),
            scheduler=self.scheduler.state_dict(),
            generator=self.gen.get_state()))

    def restore(self) -> None:
        state = load_checkpoint(self.ckpt_path())
        self.model.load_state_dict(state["model"])
        self.ensure_phase(state["phase"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.gen.set_state(state["generator"])
        self.start_epoch = state["epoch"]

    def warm_start(self, npz: str) -> None:
        """The parameters of a saved model (an npz of the flax layout);
        the optimizer, schedule and epoch count start fresh."""
        with np.load(npz) as flat:
            self.model.load_state_dict(
                convert_flax_params(dict(flat), self.model))

    # -- final bounds ------------------------------------------------------
    @torch.no_grad()
    def greedy_traces(self, M: int, bs: int, T: int):
        """(theta [M', ...], designs in the real space [M', n_ctx0 + T,
        dim_x], outcomes) of greedy rollouts, ceil(M / bs) batches."""
        task, cfg = self.task, self.cfg
        n_ctx0 = task.n_context_init
        w = target_weights(task, self.device)
        self.model.eval()
        thetas, xs, ys = [], [], []
        for _ in range((M + bs - 1) // bs):
            b = make_continuous_batch(task, self.gen, bs, T)
            _, sim_noise = draw_rollout_noise(task, self.gen, T, bs)
            ro = rollout_continuous(self.model, task, b, T, w, w, sim_noise,
                                    training=False, time_token=cfg.time_token,
                                    use_remat=False)
            thetas.append(b.theta)
            xs.append(task.unnormalise_design(torch.cat(
                [b.x[:, :n_ctx0], ro.xs.transpose(0, 1)], dim=1)))
            ys.append(torch.cat([b.y[:, :n_ctx0], ro.ys.transpose(0, 1)],
                                dim=1))
        self.model.train()
        return torch.cat(thetas), torch.cat(xs), torch.cat(ys)


def eval_final_bounds(cfg, task, theta, x, y, out_path: str
                      ) -> Dict[str, np.ndarray]:
    """The final bounds of greedy traces at the ``eval.*_final`` protocol:
    printed and saved to ``out_path`` with ``L``, ``M``, ``T``."""
    M, bs, T = cfg.eval.M_final, cfg.eval.batch_size_final, cfg.eval.T_final
    bounds = eval_eig_from_history(
        task, theta, x, y, cfg.eval.L_final, derive_seed(cfg.seed + 1),
        M=M, batch_size=bs, err_type=cfg.eval.err_type,
        L_chunk=cfg.eval.L_chunk)
    print(f"final bounds (L={cfg.eval.L_final:g}, M={M}, T={T}): "
          f"sPCE {float(bounds['pce_mean']):.4f} "
          f"± {float(bounds['pce_err']):.4f}, "
          f"sNMC {float(bounds['nmc_mean']):.4f} "
          f"± {float(bounds['nmc_err']):.4f}", flush=True)
    np.savez(out_path, **bounds, L=cfg.eval.L_final, M=M, T=T)
    return bounds


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    device, overrides = split_device(argv)
    cfg = parse_overrides(DEFAULTS + overrides)
    os.makedirs(cfg.output_dir, exist_ok=True)
    save_config(cfg, cfg.output_dir)
    trainer = ContinuousTrainer(cfg, device)
    print(f"device: {trainer.device}", flush=True)
    print(to_yaml(cfg), flush=True)
    if cfg.load_path:
        trainer.warm_start(cfg.load_path)
        print(f"warm-started params from {cfg.load_path}", flush=True)
    elif cfg.load_checkpoint and os.path.exists(trainer.ckpt_path()):
        trainer.restore()
        print(f"resumed from {trainer.ckpt_path()} at epoch "
              f"{trainer.start_epoch}", flush=True)

    tracker = RunTracker(cfg.output_dir, config=to_dict(cfg))
    epoch_s = []
    t0 = time.perf_counter()
    for epoch in range(trainer.start_epoch, cfg.max_epoch):
        t_ep = time.perf_counter()
        m = trainer.train_epoch(epoch)
        epoch_s.append(time.perf_counter() - t_ep)
        if cfg.verbose and (epoch + 1) % cfg.verbose == 0:
            m = {k: float(v) for k, v in m.items()}          # sync point
            rate = (epoch + 1 - trainer.start_epoch) / (
                time.perf_counter() - t0)
            print(f"epoch {epoch + 1}: loss {m['loss']:.4f} "
                  f"LL {m['likelihood']:.4f} "
                  f"design {m['design_loss']:.4f} "
                  f"std {m['policy_std']:.4f} ({rate:.1f} ep/s)", flush=True)
            tracker.log(m, epoch + 1)
        if cfg.checkpoint and (epoch + 1) % cfg.checkpoint == 0:
            trainer.save(epoch + 1)
    tracker.finish()
    final = save_params_npz(os.path.join(
        cfg.output_dir, "model", f"{cfg.file_name.split('.')[0]}.npz"),
        trainer.model)
    print(f"saved {final}", flush=True)

    bounds = None
    if cfg.eval.EIG:
        theta, x, y = trainer.greedy_traces(
            cfg.eval.M_final, cfg.eval.batch_size_final, cfg.eval.T_final)
        bounds = eval_final_bounds(
            cfg, trainer.task, theta, x, y,
            os.path.join(cfg.output_dir, "continuous_bounds.npz"))
    return dict(trainer=trainer, epoch_s=epoch_s, bounds=bounds)


if __name__ == "__main__":
    main()
