"""Training entry point (the port of ``train.py``), with the same
hydra-style overrides, e.g. the GP-AL-1D recipe:

    python -m aline_tpu_torch.train task=al_mix task.dim_x=1 \
        task.n_target_theta=2 task.n_query_init=200 min_T=30 T=30 \
        max_epoch=200000 burning_epoch=20000 file_name=aline_al_1d.pth

or location finding with its bounds (``eval.EIG=true``):

    python -m aline_tpu_torch.train task=location_finding eval.EIG=true \
        dtype=bfloat16 max_epoch=100000 burning_epoch=20000

and the same for ``task=ces`` (with ``eval.EIG=true``),
``task=psychometric`` (predefined target masks) and ``task=hpo
task.meta_dataset=rpart`` (batches from the host numpy generator).

Runs on the GPU unless ``device=cpu`` is given.  Writes ``config.json``,
``logs/``, ``metrics.jsonl``, the checkpoint (``<checkpoint_name>.pt``)
and the final parameters as ``model/<file_name stem>.npz`` (the flax
layout), which ``python -m aline_tpu_torch.eval_al RUN_DIR --params
RUN_DIR/model/<stem>.npz`` evaluates.  With ``eval.EIG=true``, as
``train.py``: every ``verbose`` epochs the sPCE/sNMC bounds at
``eval.{L, M, batch_size}`` and T = ``T - n_context_init`` go to
``metrics.jsonl`` (``pce_mean``, ``nmc_mean``), and after training the
per-step bounds at the ``eval.*_final`` protocol to
``eval/<stem>_N<n_query_final>_T<T_final>.npz``.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from aline_tpu_torch.config import parse_overrides, save_config, to_dict, \
    to_yaml
from aline_tpu_torch.eval.eig import derive_seed, eval_boed
from aline_tpu_torch.train.loop import Trainer
from aline_tpu_torch.utils.device import split_device
from aline_tpu_torch.utils.logging import create_logger
from aline_tpu_torch.utils.serialization import save_params_npz
from aline_tpu_torch.utils.tracking import RunTracker


def make_eval_hook(cfg):
    """``train.py``'s in-training EIG eval: final-step bounds on fresh
    batches; the seed derives from the run's seed and the epoch, so runs
    evaluate on independent batches and an epoch on the same ones."""
    def eval_hook(trainer, epoch):
        b = eval_boed(trainer.model, trainer.task,
                      cfg.T - cfg.task.n_context_init, cfg.eval.L,
                      cfg.eval.M, cfg.eval.batch_size,
                      derive_seed(cfg.seed ^ 0xE7A1, epoch), cfg.time_token,
                      stepwise=False, L_chunk=cfg.eval.L_chunk)
        return {"pce_mean": float(b["pce_mean"]),
                "nmc_mean": float(b["nmc_mean"])}
    return eval_hook


def final_bounds(cfg, trainer, logger) -> str:
    """``train.py``'s final EIG evaluation: per-step bounds at the
    ``eval.*_final`` protocol, saved under ``eval/``."""
    bounds = eval_boed(
        trainer.model, trainer.task,
        cfg.eval.T_final - cfg.task.n_context_init, cfg.eval.L_final,
        cfg.eval.M_final, cfg.eval.batch_size_final,
        derive_seed(cfg.seed + 1), cfg.time_token, stepwise=True,
        L_chunk=cfg.eval.L_chunk, n_query=cfg.eval.n_query_final,
        logger=logger)
    logger.info("Final bounds: %s", bounds)
    t_idx = min(cfg.T - 1, len(bounds["pce_mean"]) - 1)
    logger.info("PCE: %.3f+-%.3f\tNMC: %.3f+-%.3f",
                bounds["pce_mean"][t_idx], bounds["pce_err"][t_idx],
                bounds["nmc_mean"][t_idx], bounds["nmc_err"][t_idx])
    eval_dir = os.path.join(cfg.output_dir, "eval")
    os.makedirs(eval_dir, exist_ok=True)
    out = os.path.join(eval_dir, f"{cfg.file_name.split('.')[0]}"
                       f"_N{cfg.eval.n_query_final}_T{cfg.eval.T_final}.npz")
    np.savez(out, **bounds)
    logger.info("Bounds have been saved at %s.", out)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    device, overrides = split_device(argv)
    cfg = parse_overrides(overrides)
    os.makedirs(cfg.output_dir, exist_ok=True)
    logger = create_logger(os.path.join(cfg.output_dir, "logs"),
                           name=cfg.task.name or "aline")
    logger.info("Running with config:\n%s", to_yaml(cfg))
    trainer = Trainer(cfg, logger=logger, device=device)
    logger.info("Device: %s", trainer.device)
    save_config(cfg, cfg.output_dir)
    tracker = RunTracker(cfg.output_dir, config=to_dict(cfg))
    trainer.train(eval_hook=make_eval_hook(cfg) if cfg.eval.EIG else None,
                  tracker=tracker)
    tracker.finish()
    path = save_params_npz(trainer.model_path(), trainer.model)
    logger.info("Model has been saved at %s", path)
    if cfg.eval.EIG:
        final_bounds(cfg, trainer, logger)
    return trainer


if __name__ == "__main__":
    main()
