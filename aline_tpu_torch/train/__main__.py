"""Training entry point (the port of ``train.py``), with the same
hydra-style overrides, e.g. the GP-AL-1D recipe:

    python -m aline_tpu_torch.train task=al_mix task.dim_x=1 \
        task.n_target_theta=2 task.n_query_init=200 min_T=30 T=30 \
        max_epoch=200000 burning_epoch=20000 file_name=aline_al_1d.pth

Runs on the GPU unless ``device=cpu`` is given.  Writes ``config.json``,
``logs/``, ``metrics.jsonl``, the checkpoint (``<checkpoint_name>.pt``)
and the final parameters as ``model/<file_name stem>.npz`` (the flax
layout), which ``python -m aline_tpu_torch.eval_al RUN_DIR --params
RUN_DIR/model/<stem>.npz`` evaluates.  The in-training EIG eval of
``train.py`` is not ported: ``eval.EIG=true`` is refused.
"""
from __future__ import annotations

import os
import sys

from aline_tpu_torch.config import parse_overrides, save_config, to_dict, \
    to_yaml
from aline_tpu_torch.train.loop import Trainer
from aline_tpu_torch.utils.logging import create_logger
from aline_tpu_torch.utils.serialization import save_params_npz
from aline_tpu_torch.utils.tracking import RunTracker


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cuda"
    overrides = []
    for arg in argv:
        if arg.startswith("device="):
            device = arg.partition("=")[2]
        else:
            overrides.append(arg)
    cfg = parse_overrides(overrides)
    os.makedirs(cfg.output_dir, exist_ok=True)
    logger = create_logger(os.path.join(cfg.output_dir, "logs"),
                           name=cfg.task.name or "aline")
    logger.info("Running with config:\n%s", to_yaml(cfg))
    trainer = Trainer(cfg, logger=logger, device=device)
    logger.info("Device: %s", trainer.device)
    save_config(cfg, cfg.output_dir)
    tracker = RunTracker(cfg.output_dir, config=to_dict(cfg))
    trainer.train(tracker=tracker)
    tracker.finish()
    path = save_params_npz(trainer.model_path(), trainer.model)
    logger.info("Model has been saved at %s", path)
    return trainer


if __name__ == "__main__":
    main()
