"""Run configuration: the dataclasses a run's ``config.json`` holds.

A copy of the fields of ``aline_tpu/config.py`` (same names and defaults,
so a run directory written by the JAX trainer loads unchanged), of its
hydra-style ``key=value`` override parser and the task presets, and of
the JSON reader and writer in ``aline_tpu/utils/serialization.py``.
"""
from __future__ import annotations

import ast
import copy
import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple


@dataclass
class EncoderConfig:
    """Transformer encoder (``aline_tpu/config.py`` EncoderConfig)."""
    dim_embedding: int = 32
    dim_feedforward: int = 128
    n_head: int = 4
    dropout: float = 0.0
    num_layers: int = 3
    attention_impl: str = "auto"   # "auto" | "compact" | "flash" | "naive"
    with_time_token: bool = False
    dtype: str = "float32"


@dataclass
class HeadConfig:
    """Output head (``aline_tpu/config.py`` HeadConfig)."""
    num_components: int = 10
    single_head: bool = False
    std_min: float = 1e-4
    value_head: bool = False
    continuous: bool = False
    policy_log_std_min: float = -20.0
    policy_log_std_max: float = 2.0
    # "auto" | "on" | "off": which token sets take the GMM kernel
    # (models/heads.py GMMTargetHead)
    fused_gmm: str = "auto"


@dataclass
class EmbedderConfig:
    continuous: bool = False


@dataclass
class EvalConfig:
    """Evaluation settings (``aline_tpu/config.py`` EvalConfig)."""
    EIG: bool = False
    L: int = 50_000
    M: int = 2_000
    batch_size: int = 500
    L_final: int = 10_000_000
    M_final: int = 2_000
    batch_size_final: int = 5
    n_query_final: int = 2_000
    T_final: int = 30
    L_chunk: int = 32_768
    err_type: str = "se"


EVAL_PRESETS = {
    "default": EvalConfig(),
    "bed": EvalConfig(EIG=True),
}


@dataclass
class TaskConfig:
    """Base task config (``aline_tpu/config.py`` TaskConfig)."""
    target: str = ""
    name: str = ""
    dim_x: int = 1
    dim_y: int = 1
    embedding_type: str = "data"  # "data" | "theta" | "mix"
    mask_type: List[str] = field(default_factory=lambda: ["all"])
    n_selected_targets: Optional[int] = None
    predefined_masks: Optional[List[List[bool]]] = None
    predefined_mask_weights: Optional[List[float]] = None
    mask_index: Optional[int] = None
    attend_to: Optional[str] = None
    n_context_init: int = 1
    n_query_init: int = 200
    n_target_data: int = 0
    n_target_theta: int = 0
    design_scale: float = 5.0
    noise_scale: float = 0.01


@dataclass
class GPTaskConfig(TaskConfig):
    """GP active-learning task (``aline_tpu/config.py`` GPTaskConfig)."""
    target: str = "gp"
    p_iso: float = 0.5
    kernel_weights: Optional[List[float]] = None   # defaults to [1/3,0,1/3,1/3]
    lengthscale_lower: float = 0.1
    lengthscale_upper: float = 2.0
    data_gen: str = "uniform"


@dataclass
class LocationFindingConfig(TaskConfig):
    """Hidden-source location finding (``aline_tpu/config.py``
    LocationFindingConfig)."""
    target: str = "location_finding"
    K: int = 1
    theta_dist: str = "uniform"
    outcome_scale: float = 10.0
    base_signal: float = 0.1
    max_signal: float = 1e-4


@dataclass
class CESTaskConfig(TaskConfig):
    """CES utility experiment (``aline_tpu/config.py`` CESTaskConfig)."""
    target: str = "ces"
    epsilon: float = 2.0 ** (-22)
    # the censored tail's asymptote: "log_ndtr" (exact, the default) or
    # "reference" (the reference's hand-rolled branch, for parity runs)
    tail_mode: str = "log_ndtr"


@dataclass
class PsychometricConfig(TaskConfig):
    """Psychometric function task (``aline_tpu/config.py``
    PsychometricConfig)."""
    target: str = "psychometric"


@dataclass
class BenchmarkTaskConfig(TaskConfig):
    """Analytic benchmark functions, eval-only (``aline_tpu/config.py``
    BenchmarkTaskConfig)."""
    target: str = "benchmark"
    benchmark_name: str = "forrester"


@dataclass
class HPOTaskConfig(TaskConfig):
    """HPO-B lookup task (``aline_tpu/config.py`` HPOTaskConfig)."""
    target: str = "hpo"
    meta_dataset: str = "ranger"
    min_n_context: int = 5
    max_n_context: int = 10
    normalize_y: bool = False
    data_path: Optional[str] = None


def _task_presets():
    """The task presets of ``aline_tpu/config.py`` (the reference's
    config/task/*.yaml values)."""
    return {
        "al_data": GPTaskConfig(
            name="AL_data", dim_x=1, embedding_type="data",
            mask_type=["all"], n_context_init=1, n_query_init=200,
            n_target_data=100, n_target_theta=0,
            design_scale=5.0, noise_scale=0.01),
        "al_mix": GPTaskConfig(
            name="AL_mix", dim_x=2, embedding_type="mix",
            mask_type=["split"], n_context_init=1, n_query_init=200,
            n_target_data=100, n_target_theta=3,
            design_scale=5.0, noise_scale=0.01),
        "al_theta": GPTaskConfig(
            name="AL_theta", dim_x=1, embedding_type="theta",
            mask_type=["all"], n_context_init=1, n_query_init=200,
            n_target_data=0, n_target_theta=2,
            design_scale=5.0, noise_scale=0.01),
        "ces": CESTaskConfig(
            name="CES", dim_x=6, embedding_type="theta",
            mask_type=["all"], n_context_init=1, n_query_init=200,
            n_target_data=0, n_target_theta=5,
            design_scale=100.0, noise_scale=0.005),
        "location_finding": LocationFindingConfig(
            name="Location", dim_x=2, embedding_type="theta",
            mask_type=["all"], n_context_init=1, n_query_init=200,
            n_target_data=0, n_target_theta=2, K=1,
            theta_dist="uniform", design_scale=1.0, outcome_scale=10.0,
            noise_scale=0.5, base_signal=0.1, max_signal=1e-4),
        "psychometric": PsychometricConfig(
            name="Psychometric", dim_x=1, embedding_type="theta",
            mask_type=["predefined"],
            predefined_masks=[[False, False, True, True],
                              [True, True, False, False]],
            predefined_mask_weights=[1.0, 1.0],
            n_context_init=1, n_query_init=200,
            n_target_data=0, n_target_theta=4, design_scale=5.0),
        "hpo": HPOTaskConfig(
            name="HPO", dim_x=9, embedding_type="data",
            mask_type=["all"], n_context_init=5, n_query_init=100,
            n_target_data=100, n_target_theta=0,
            meta_dataset="ranger"),
        "benchmark": BenchmarkTaskConfig(
            name="Benchmark", dim_x=1, embedding_type="data",
            mask_type=["all"], n_context_init=5, n_query_init=10,
            n_target_data=5, design_scale=5.0, noise_scale=0.1),
    }


@dataclass
class Config:
    """Root run config (``aline_tpu/config.py`` Config)."""
    seed: int = 123
    fix_seed: bool = True
    max_epoch: int = 100_000
    burning_epoch: int = 10_000
    batch_size: int = 200
    min_T: int = 30
    T: int = 30
    time_token: bool = False
    optimizer: str = "AdamW"
    lr: float = 1e-3
    lr_warmup: int = 0
    gamma: float = 1.0
    alpha: float = 1.0
    alpha_pce: float = 0.0
    pce_L: int = 255
    explore_std: float = 0.0
    clip_grads: bool = True
    verbose: int = 500
    checkpoint: int = 100
    load_checkpoint: bool = False
    load_path: Optional[str] = None
    checkpoint_name: str = "ckpt.tar"
    output_dir: str = "./outputs"
    file_name: str = "aline.pth"
    mesh_data: int = 0
    # recompute each rollout step's activations in the backward pass
    # (torch.utils.checkpoint per step)
    rollout_remat: bool = True
    # "full" only; "dots" (save matmul outputs) is not ported yet
    remat_policy: str = "full"
    # lax.scan's unroll factor: no meaning outside XLA, not read here
    rollout_unroll: int = 1
    static_mask_keys: bool = True
    static_mask_keys_max: int = 4
    dtype: str = "float32"
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    profile_epochs: int = 3
    task: TaskConfig = field(default_factory=lambda: _task_presets()["al_mix"])
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    embedder: EmbedderConfig = field(default_factory=EmbedderConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)


# The ported tasks; other targets load as the base TaskConfig and are
# refused by tasks.build_task.
_TASK_CFG_BY_TARGET = {"gp": GPTaskConfig,
                       "location_finding": LocationFindingConfig,
                       "ces": CESTaskConfig,
                       "psychometric": PsychometricConfig,
                       "benchmark": BenchmarkTaskConfig,
                       "hpo": HPOTaskConfig}
_GROUPS = {"encoder": EncoderConfig, "embedder": EmbedderConfig,
           "head": HeadConfig, "eval": EvalConfig}


def _from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def config_from_dict(d: dict) -> Config:
    """Build a Config from the dict of a run's ``config.json`` (unknown
    keys are dropped, as ``aline_tpu.utils.serialization`` does)."""
    task = d.get("task", {})
    cfg = _from_dict(Config, {k: v for k, v in d.items()
                              if k != "task" and k not in _GROUPS})
    cfg.task = _from_dict(
        _TASK_CFG_BY_TARGET.get(task.get("target", ""), TaskConfig), task)
    for name, cls in _GROUPS.items():
        setattr(cfg, name, _from_dict(cls, d.get(name, {})))
    return cfg


def load_config(run_dir: str) -> Config:
    with open(os.path.join(run_dir, "config.json")) as f:
        return config_from_dict(json.load(f))


def save_config(cfg: Config, output_dir: str) -> str:
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "config.json")
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2, default=str)
    return path


# -- CLI overrides ------------------------------------------------------------

def _coerce(value_str: str, current: Any):
    """Coerce a CLI string to the type of ``current`` (the existing value)."""
    s = value_str.strip()
    if s.lower() in ("null", "none"):
        return None
    if isinstance(current, bool):
        if s.lower() in ("true", "1", "yes"):
            return True
        if s.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot parse bool from {s!r}")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(float(s))
    if isinstance(current, float):
        return float(s)
    if isinstance(current, (list, tuple)) or current is None:
        # python or JSON text, e.g. [split] or [[false,true],[true,false]]
        try:
            normalized = re.sub(
                r"\b(true|false|null)\b",
                lambda m: {"true": "True", "false": "False",
                           "null": "None"}[m.group(0)], s)
            return ast.literal_eval(normalized)
        except (ValueError, SyntaxError):
            # bare comma-separated or single token: strings
            if s.startswith("[") and s.endswith("]"):
                inner = s[1:-1].strip()
                if not inner:
                    return []
                return [tok.strip().strip("'\"")
                        for tok in inner.split(",")]
            return s
    return s


def _set_dotted(cfg: Any, dotted: str, value_str: str) -> None:
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"unknown config group {p!r} in {dotted!r}")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not dataclasses.is_dataclass(obj) or not hasattr(obj, leaf):
        raise KeyError(f"unknown config key {dotted!r}")
    setattr(obj, leaf, _coerce(value_str, getattr(obj, leaf)))


def parse_overrides(argv: Sequence[str],
                    base: Optional[Config] = None) -> Config:
    """A Config from hydra-style ``key=value`` overrides, as
    ``aline_tpu.config.parse_overrides`` builds it: group selections
    (``task=``, ``eval=``) first, then the dotted keys, then
    ``min_T <= T``."""
    cfg = copy.deepcopy(base) if base is not None else Config()
    dotted: List[Tuple[str, str]] = []
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"override {arg!r} is not of the form key=value")
        key, _, val = arg.partition("=")
        key = key.strip()
        if key == "task":
            presets = _task_presets()
            if val not in presets:
                raise KeyError(f"unknown task preset {val!r}; available: "
                               f"{sorted(presets)}")
            cfg.task = presets[val]
        elif key == "eval":
            if val not in EVAL_PRESETS:
                raise KeyError(f"unknown eval preset {val!r}")
            cfg.eval = copy.deepcopy(EVAL_PRESETS[val])
        elif key in ("encoder", "embedder", "head"):
            pass  # single presets
        else:
            dotted.append((key, val))
    for key, val in dotted:
        _set_dotted(cfg, key, val)
    # the reference's rule (train_aline.py:202-203)
    if cfg.min_T > cfg.T:
        cfg.min_T = cfg.T
    return cfg


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def to_yaml(cfg: Any) -> str:
    """Readable dump of the config (indented JSON; no yaml dependency)."""
    return json.dumps(to_dict(cfg), indent=2, default=str)
