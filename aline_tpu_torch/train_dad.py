"""Train the DAD baseline (Foster et al. 2021) by the pathwise sPCE
objective on the card (the port of ``scripts/train_dad.py``).

    python -m aline_tpu_torch.train_dad max_epoch=20000 \
        output_dir=outputs/dad_loc

Overrides are the run config's, after ``DEFAULTS`` (location finding,
B=256, T=30); ``device=cpu`` runs on the CPU.  Each epoch rolls out B
traces (``models/baselines.py`` ``run_trace``: the simulator is
reparameterised, so the sPCE loss over ``eval.L`` contrastive thetas
differentiates through the whole trace) and takes one Adam step with
``optax.cosine_decay_schedule(lr, max_epoch)`` written as its closed
form.  Writes ``config.json``, ``metrics.jsonl`` (every ``verbose``
epochs), ``ckpt_dad.pt`` (every ``checkpoint`` epochs; resumed bit for bit
with ``load_checkpoint=true``), ``model/<file_name stem>.npz`` (the flax
layout of the DAD network) and, with ``eval.EIG`` (on by default), the
final bounds of ``eval.M_final`` traces of ``eval.T_final`` steps at
``eval.L_final`` in ``dad_bounds.npz``.
"""
from __future__ import annotations

import math
import os
import sys
import time

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR

from aline_tpu_torch.config import parse_overrides, save_config, to_dict, \
    to_yaml
from aline_tpu_torch.eval.eig_losses import pce_loss
from aline_tpu_torch.models.baselines import (
    SetEquivariantDesignNetwork,
    draw_trace,
    run_trace,
)
from aline_tpu_torch.tasks import build_task
from aline_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from aline_tpu_torch.train.optimizer import cosine_factor
from aline_tpu_torch.train_continuous import eval_final_bounds
from aline_tpu_torch.utils.device import resolve_device, split_device
from aline_tpu_torch.utils.serialization import save_params_npz
from aline_tpu_torch.utils.tracking import RunTracker

DEFAULTS = [
    "task=location_finding", "task.theta_dist=uniform",
    "task.n_target_theta=2", "task.K=1", "task.n_query_init=1",
    "lr=5e-4", "T=30", "batch_size=256", "max_epoch=20000",
    "verbose=500", "checkpoint=2000", "eval.L=511",
    "eval.EIG=true", "eval.L_final=1000000", "eval.M_final=400",
    "eval.batch_size_final=200", "eval.T_final=30",
    "output_dir=outputs/dad_loc", "file_name=dad.pth",
]


def dad_loss(model, task, theta, sim_noise, explore_noise, contrastive,
             explore_std: float) -> torch.Tensor:
    """The sPCE loss of one batch of traces against ``contrastive`` [L,
    B, ...] thetas (theta_0 prepended)."""
    theta0, xs, ys = run_trace(model, task, theta, sim_noise, explore_noise,
                               explore_std)
    return pce_loss(task, ys, xs, torch.cat([theta0[None], contrastive]))


class DADTrainer:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.task = build_task(cfg.task)
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(cfg.seed)
            model = SetEquivariantDesignNetwork(self.task.dim_x,
                                                self.task.dim_y)
        self.model = model.to(self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # optax.adam(cosine_decay_schedule(lr, max_epoch)): torch's Adam is
        # optax's update (ε outside the square root, bias-corrected)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.scheduler = LambdaLR(self.optimizer,
                                  cosine_factor(cfg.max_epoch))
        self.start_epoch = 0

    def draw(self, B: int):
        cfg, task = self.cfg, self.task
        theta, sim, explore = draw_trace(task, self.gen, cfg.T, B)
        return theta, sim, explore, task.sample_theta(self.gen,
                                                      (cfg.eval.L, B))

    def train_epoch(self) -> torch.Tensor:
        loss = dad_loss(self.model, self.task, *self.draw(self.cfg.batch_size),
                        self.cfg.explore_std)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        return loss.detach()

    def ckpt_path(self) -> str:
        return os.path.join(self.cfg.output_dir, "ckpt_dad.pt")

    def save(self, epoch: int) -> str:
        return save_checkpoint(self.ckpt_path(), dict(
            epoch=epoch, model=self.model.state_dict(),
            optimizer=self.optimizer.state_dict(),
            scheduler=self.scheduler.state_dict(),
            generator=self.gen.get_state()))

    def restore(self) -> None:
        state = load_checkpoint(self.ckpt_path())
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.gen.set_state(state["generator"])
        self.start_epoch = state["epoch"]

    @torch.no_grad()
    def traces(self, M: int, bs: int, T: int):
        """ceil(M / bs) batches of deterministic traces (no exploration)."""
        thetas, xs, ys = [], [], []
        for _ in range((M + bs - 1) // bs):
            theta, sim, _ = draw_trace(self.task, self.gen, T, bs)
            th, x, y = run_trace(self.model, self.task, theta, sim)
            thetas.append(th)
            xs.append(x)
            ys.append(y)
        return torch.cat(thetas), torch.cat(xs), torch.cat(ys)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    device, overrides = split_device(argv)
    cfg = parse_overrides(DEFAULTS + overrides)
    os.makedirs(cfg.output_dir, exist_ok=True)
    save_config(cfg, cfg.output_dir)
    trainer = DADTrainer(cfg, device)
    print(f"device: {trainer.device}", flush=True)
    print(to_yaml(cfg), flush=True)
    if cfg.load_checkpoint and os.path.exists(trainer.ckpt_path()):
        trainer.restore()
        print(f"resumed from {trainer.ckpt_path()} at epoch "
              f"{trainer.start_epoch}", flush=True)

    tracker = RunTracker(cfg.output_dir, config=to_dict(cfg))
    log_lp1 = math.log(cfg.eval.L + 1)
    epoch_s = []
    t0 = time.perf_counter()
    for epoch in range(trainer.start_epoch, cfg.max_epoch):
        t_ep = time.perf_counter()
        loss = trainer.train_epoch()
        epoch_s.append(time.perf_counter() - t_ep)
        if cfg.verbose and (epoch + 1) % cfg.verbose == 0:
            loss = float(loss)                               # sync point
            rate = (epoch + 1 - trainer.start_epoch) / (
                time.perf_counter() - t0)
            print(f"epoch {epoch + 1}: pce_loss {loss:.4f} train "
                  f"sPCE(L={cfg.eval.L}) {log_lp1 - loss:.4f} "
                  f"({rate:.1f} ep/s)", flush=True)
            tracker.log(dict(loss=loss, spce_train=log_lp1 - loss),
                        epoch + 1)
        if cfg.checkpoint and (epoch + 1) % cfg.checkpoint == 0:
            trainer.save(epoch + 1)
    tracker.finish()
    final = save_params_npz(os.path.join(
        cfg.output_dir, "model", f"{cfg.file_name.split('.')[0]}.npz"),
        trainer.model)
    print(f"saved {final}", flush=True)

    bounds = None
    if cfg.eval.EIG:
        theta, x, y = trainer.traces(cfg.eval.M_final,
                                     cfg.eval.batch_size_final,
                                     cfg.eval.T_final)
        bounds = eval_final_bounds(cfg, trainer.task, theta, x, y,
                                   os.path.join(cfg.output_dir,
                                                "dad_bounds.npz"))
    return dict(trainer=trainer, epoch_s=epoch_s, bounds=bounds)


if __name__ == "__main__":
    main()
