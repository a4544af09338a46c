"""Two-phase AdamW with the burning-stage layerwise learning rates
(``aline_tpu/train/optimizer.py``).

* burning phase (epoch < burning_epoch): one group, cosine-annealed over
  ``max_epoch`` steps;
* main phase: the optimizer is rebuilt (Adam moments reset) with two
  groups, the ``predictor`` parameters at lr and the shared ones at lr/5,
  each annealed over ``max_epoch - burning_epoch`` steps.

Gradients are clipped by their infinity norm at 1.0.  optax's ``adamw``
applies decay as ``-lr·(û + wd·p)`` and ``torch.optim.AdamW`` as
``p·(1 - lr·wd)`` then ``-lr·û``; both read the old p, so they agree
(``tests/test_torch_train.py`` holds them to each other).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR

# optax.adamw as aline_tpu configures it: torch AdamW's defaults
ADAMW_KW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


def clip_by_inf_norm(params: Iterable[torch.Tensor], max_norm: float
                     ) -> torch.Tensor:
    """Scale every gradient by ``min(1, max_norm / (‖g‖∞ + 1e-6))``
    (torch's ``clip_grad_norm_`` with ``norm_type=inf`` is that formula);
    returns ‖g‖∞."""
    return torch.nn.utils.clip_grad_norm_(params, max_norm,
                                          norm_type=math.inf)


def cosine_factor(decay_steps: int, warmup: int = 0
                  ) -> Callable[[int], float]:
    """The multiplier of the base lr at step t: optax's
    ``cosine_decay_schedule`` (alpha 0), or with ``warmup`` > 0 its
    ``warmup_cosine_decay_schedule`` from 0 (a linear ramp, then the
    cosine over the remaining steps)."""
    if warmup > 0:
        decay = max(decay_steps, warmup + 1) - warmup

        def factor(t):
            if t < warmup:
                return t / warmup
            return 0.5 * (1 + math.cos(math.pi * min(t - warmup, decay)
                                       / decay))
        return factor
    n = max(decay_steps, 1)
    return lambda t: 0.5 * (1 + math.cos(math.pi * min(t, n) / n))


def is_predictor(name: str) -> bool:
    """The reference's partition: 'predictor' in the parameter's name."""
    return "predictor" in name


def build_optimizer(cfg, model: torch.nn.Module, phase: str
                    ) -> Tuple[torch.optim.AdamW, LambdaLR]:
    """(AdamW, its schedule) for the 'burning' or 'main' phase.  Call
    ``scheduler.step()`` after each ``optimizer.step()``."""
    if cfg.optimizer.lower() != "adamw":
        raise ValueError(f"unsupported optimizer {cfg.optimizer!r}")
    warmup = int(cfg.lr_warmup)
    named = list(model.named_parameters())
    if phase == "burning":
        groups = [{"params": [p for _, p in named], "lr": cfg.lr}]
        factors = [cosine_factor(cfg.max_epoch, warmup)]
    elif phase == "main":
        steps = cfg.max_epoch - cfg.burning_epoch
        groups = [
            {"params": [p for n, p in named if is_predictor(n)],
             "lr": cfg.lr},
            {"params": [p for n, p in named if not is_predictor(n)],
             "lr": cfg.lr / 5.0}]
        factors = [cosine_factor(steps, warmup)] * 2
    else:
        raise ValueError(f"unknown phase {phase!r}")
    opt = torch.optim.AdamW(groups, **ADAMW_KW)
    return opt, LambdaLR(opt, factors)


def phase_for_epoch(cfg, epoch: int) -> str:
    return "burning" if epoch < cfg.burning_epoch else "main"
