"""Simulators: the GP active-learning task, location finding, CES, the
psychometric function, the analytic benchmark functions and the HPO-B
lookup task."""
from aline_tpu_torch.tasks.base import (  # noqa: F401
    Batch, Task, batch_from_numpy, init_ctx_idx, select_design)
from aline_tpu_torch.tasks.benchmarks import (  # noqa: F401
    BENCHMARKS, BenchmarkTask)
from aline_tpu_torch.tasks.ces import CESTask
from aline_tpu_torch.tasks.gp import GPTask
from aline_tpu_torch.tasks.hpo import HPOTask
from aline_tpu_torch.tasks.location_finding import HiddenLocation
from aline_tpu_torch.tasks.psychometric import PsychometricTask

_TASK_REGISTRY = {"gp": GPTask, "location_finding": HiddenLocation,
                  "ces": CESTask, "psychometric": PsychometricTask,
                  "benchmark": BenchmarkTask, "hpo": HPOTask}


def build_task(cfg) -> Task:
    try:
        cls = _TASK_REGISTRY[cfg.target]
    except KeyError:
        raise NotImplementedError(
            f"task {cfg.target!r} is not ported yet (ported: "
            f"{sorted(_TASK_REGISTRY)})") from None
    return cls(cfg)
