"""Typed configuration: nested frozen dataclasses, loaded from JSON files
with `key=value` dotted overrides.

A copy of `ron_tensorflow_tpu/config.py` (ref: ron_net.py:52-180,
eval_ron_network.py:40-135): the same field names and defaults, so that the
JAX package's config files load here.

`mesh_shape` is a (data, model) grid over the ranks of a multi-process
run (`parallel.mesh`). In training, `data.batch_size` is each data rank's
local batch; in eval it is the global batch, which must divide by the
data-axis size (JAX `config.py:144-146`): each data rank scores its rows.
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
    mesh_shape: Optional[Tuple[int, int]] = None  # (data, model) over the world's ranks; None => (world, 1)
    # save a checkpoint and exit 75 (EX_TEMPFAIL) once the host RSS exceeds
    # this many GB, for a supervisor to restart; 0 = off
    max_host_rss_gb: float = 0.0
    tensorboard: bool = True  # events.out.tfevents.* next to metrics.jsonl
    # every N steps, sample 0 of the augmented batch with its gt boxes as
    # <model_dir>/debug/step_<N>.jpg; 0 = off
    dump_debug_images_every: int = 0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    model: str = "ron_320_vgg"
    model_dir: str = "./model"
    data: DataConfig = DataConfig(
        dataset_name="pascalvoc_2007", split_name="test",
        file_pattern="voc_2007_test_*.tfrecord", batch_size=8, shuffle=False,
        keep_difficult=True,
    )
    match: MatchConfig = MatchConfig(positive_threshold=0.5)
    # detection pipeline (ref: eval_ron_network.py:64-75)
    select_threshold: float = 0.01
    objectness_threshold: float = 0.03
    select_top_k: int = 200
    keep_top_k: int = 100
    nms_threshold: float = 0.4
    shared_top_k: int = 0  # whole-image candidate preselection (DetectionConfig.shared_top_k); 0 = off
    matching_threshold: float = 0.5
    # the model's losses on eval batches beside the mAP (ref: eval_ron_network.py:212-220),
    # gts encoded at match.positive_threshold
    report_loss: bool = True
    max_batches: Optional[int] = None
    use_ema: bool = False
    bfloat16: bool = True
    # (data, model): each data rank scores its rows of every batch (model 1);
    # None => one process
    mesh_shape: Optional[Tuple[int, int]] = None
    # continuous eval: evaluate every new checkpoint in model_dir
    # (ref: eval_ssd_network.py:101,305-340)
    wait_for_checkpoints: bool = False
    eval_interval_secs: float = 60.0
    max_evals: Optional[int] = None  # stop after N evaluations (None = forever)
    # boxed-JPEG dumps of post-NMS detections (ref: eval_ron_network.py:240-247); None = off
    debug_dir: Optional[str] = None
    debug_max_images: int = 64
    # WARP_RESIZE | CENTRAL_CROP | PAD_AND_RESIZE (ref: eval_ssd_network.py
    # eval_resize_option); 'NONE' needs the realtime evaluator
    resize: str = "WARP_RESIZE"

    def __post_init__(self):
        if self.mesh_shape and self.data.batch_size % self.mesh_shape[0]:
            raise ValueError(f"eval batch_size {self.data.batch_size} does not divide over the data axis of "
                             f"mesh {tuple(self.mesh_shape)}")


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


def load_config(cls, path: Optional[str] = None, overrides: Sequence[str] = (), base=None):
    """Build a config from an optional base (preset) + JSON file + dotted
    overrides; the file replaces the base, overrides apply last."""
    cfg = base if base is not None else cls()
    if path:
        with open(path) as f:
            data = json.load(f)
        cfg = _from_dict(cls, data)
    return apply_overrides(cfg, overrides)


def _from_dict(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.default) and isinstance(v, dict):
            kwargs[f.name] = _from_dict(type(f.default), v)
        else:
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def print_config(cfg, stream=None) -> None:
    """Console dump of a config (ref: tf_utils.print_configuration:61-89)."""
    print(json.dumps(config_to_dict(cfg), indent=2, default=str), file=stream)
