"""Run configuration: the dataclasses a run's ``config.json`` holds.

A copy of the fields of ``aline_tpu/config.py`` (same names and defaults,
so a run directory written by the JAX trainer loads unchanged) and of the
JSON loader in ``aline_tpu/utils/serialization.py``.  The CLI override
machinery of the JAX package belongs to training and is not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class EncoderConfig:
    """Transformer encoder (``aline_tpu/config.py`` EncoderConfig)."""
    dim_embedding: int = 32
    dim_feedforward: int = 128
    n_head: int = 4
    dropout: float = 0.0
    num_layers: int = 3
    # "auto" | "compact" | "naive"; "flash" is not ported yet
    attention_impl: str = "auto"
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
    # Read but not acted on: the port's GMM head always goes through
    # ops.gmm_head_kernel (the CUDA kernel on the card, the plain version
    # on the CPU).
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
    rollout_remat: bool = True
    remat_policy: str = "full"
    rollout_unroll: int = 1
    static_mask_keys: bool = True
    static_mask_keys_max: int = 4
    dtype: str = "float32"
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    profile_epochs: int = 3
    task: TaskConfig = field(default_factory=GPTaskConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    embedder: EmbedderConfig = field(default_factory=EmbedderConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)


# Only the GP task is ported; other targets load as the base TaskConfig
# and are refused by tasks.build_task.
_TASK_CFG_BY_TARGET = {"gp": GPTaskConfig}
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
