"""Typed training configuration.

A copy of `DataConfig`, `MatchConfig`, `TrainConfig` and `apply_overrides`
from `ron_tensorflow_tpu/config.py` (ref: ron_net.py:52-180): the same
field names and defaults. Options of the JAX trainer that the port does not
run yet raise in `train.trainer.Trainer`: `s2d_stem`, a `mesh_shape` over
more than one device, `data.use_grain`. `EvalConfig` and the rest wait for
the CLI slice (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence, Tuple

from .losses.ron import RonLossConfig
from .train.optimizer import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset_dir: str = ""
    dataset_name: str = "pascalvoc_2007_2012"
    split_name: str = "train"
    file_pattern: str = "voc_20??_train_*.tfrecord"
    batch_size: int = 14  # ref: ron_net.py:152-153
    working_shape: Tuple[int, int] = (512, 512)
    max_boxes: int = 56
    shuffle: bool = True
    keep_difficult: bool = False
    num_workers: int = 1
    worker_index: int = 0
    cache_decoded: bool = True
    use_grain: bool = False


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    # ref: ron_net.py:56-63 (train) / eval_ron_network.py:64-90 (eval)
    positive_threshold: float = 0.56
    ignore_threshold: float = 0.3


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: str = "ron_320_vgg"
    model_dir: str = "./model"
    max_steps: int = 120000  # ref: README.md:34 (~120k)
    data: DataConfig = DataConfig()
    match: MatchConfig = MatchConfig()
    loss: RonLossConfig = RonLossConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    seed: int = 0
    augment_variant: str = "auto"  # 'auto' = the model family's chain; 'ron' | 'ssd'
    bfloat16: bool = True
    # train-time BatchNorm: f32 statistics, the normalize in bf16 (BatchNorm.fast_normalize)
    bn_fast_normalize: bool = False
    # block 1 through the fused kernel (K-B) with its recompute backward; taken
    # for a bf16 model on a CUDA device at shapes the kernel supports
    fuse_block1: bool = False
    s2d_stem: bool = False
    log_every_steps: int = 10  # ref: log_every_n_steps
    save_every_steps: int = 2000
    save_interval_secs: float = 7200.0  # ref: ron_net.py:415
    max_to_keep: int = 5  # ref: ron_net.py:396
    ema_decay: Optional[float] = None
    # warm start (ref: ron_net.py:125-148 fine-tuning flags)
    checkpoint_path: Optional[str] = None
    checkpoint_format: str = "torch"
    checkpoint_exclude_scopes: Tuple[str, ...] = ("reverse",)
    checkpoint_model_scope: Optional[str] = None
    checkpoint_bgr_to_rgb: bool = False
    mesh_shape: Optional[Tuple[int, int]] = None  # None => one device
    # save a checkpoint and exit 75 (EX_TEMPFAIL) once the host RSS exceeds
    # this many GB, for a supervisor to restart; 0 = off
    max_host_rss_gb: float = 0.0
    tensorboard: bool = True  # events.out.tfevents.* next to metrics.jsonl
    # every N steps, sample 0 of the augmented batch with its gt boxes as
    # <model_dir>/debug/step_<N>.jpg; 0 = off
    dump_debug_images_every: int = 0


def _coerce(value: str, field_type) -> Any:
    if field_type in (int, "int", Optional[int]):
        return int(value)
    if field_type in (float, "float", Optional[float]):
        return float(value)
    if field_type in (bool, "bool"):
        return value.lower() in ("1", "true", "yes")
    if field_type in (str, "str", Optional[str]):
        return value
    try:
        return json.loads(value)
    except json.JSONDecodeError:
        return value


def apply_overrides(cfg, overrides: Sequence[str]):
    """Apply 'a.b.c=value' overrides to a (possibly nested) frozen dataclass."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not key=value")
        key, value = ov.split("=", 1)
        cfg = _apply_one(cfg, key.split("."), value)
    return cfg


def _apply_one(cfg, parts, value):
    if len(parts) == 1:
        fields = {f.name: f for f in dataclasses.fields(cfg)}
        if parts[0] not in fields:
            raise KeyError(f"unknown config field {parts[0]!r} on {type(cfg).__name__}")
        return dataclasses.replace(cfg, **{parts[0]: _coerce(value, fields[parts[0]].type)})
    child = getattr(cfg, parts[0])
    return dataclasses.replace(cfg, **{parts[0]: _apply_one(child, parts[1:], value)})


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def print_config(cfg, stream=None) -> None:
    """Console dump of a config (ref: tf_utils.print_configuration:61-89)."""
    print(json.dumps(config_to_dict(cfg), indent=2, default=str), file=stream)
