"""Simulators: the GP active-learning task and location finding."""
from aline_tpu_torch.tasks.base import (  # noqa: F401
    Batch, Task, batch_from_numpy, init_ctx_idx, select_design)
from aline_tpu_torch.tasks.gp import GPTask
from aline_tpu_torch.tasks.location_finding import HiddenLocation

_TASK_REGISTRY = {"gp": GPTask, "location_finding": HiddenLocation}


def build_task(cfg) -> Task:
    try:
        cls = _TASK_REGISTRY[cfg.target]
    except KeyError:
        raise NotImplementedError(
            f"task {cfg.target!r} is not ported yet (ported: "
            f"{sorted(_TASK_REGISTRY)})") from None
    return cls(cfg)
