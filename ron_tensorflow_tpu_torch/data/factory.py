"""Dataset and preprocessing factories: string-keyed registries.

A copy of `ron_tensorflow_tpu/data/factory.py` over the port's
`data/tfrecord.py`, `data/voc.py` and `data/preprocess.py` (ref:
datasets/dataset_factory.py:28-83, preprocessing/preprocessing_factory.py:32-61).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .preprocess import PreprocessConfig
from .tfrecord import list_shards, shard_for_worker
from .voc import SPLITS, SplitInfo


def get_dataset(
    name: str,
    split_name: str,
    dataset_dir: str,
    num_workers: int = 1,
    worker_index: int = 0,
) -> Tuple[SplitInfo, List[str]]:
    """(split metadata, shard files) of a registered dataset. With several
    workers, worker `worker_index`'s slice of the sorted files, as the
    reference's `get_replica_dataset` (ref: datasets/dataset_factory.py:57-83,
    pascalvoc_common.py:76-88)."""
    if name not in SPLITS:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(SPLITS)}")
    if split_name not in SPLITS[name]:
        raise ValueError(f"unknown split {split_name!r} for {name}; options: {sorted(SPLITS[name])}")
    info = SPLITS[name][split_name]
    files = list_shards(dataset_dir, info.file_pattern)
    if not files:
        raise FileNotFoundError(f"no shards matching {info.file_pattern!r} in {dataset_dir!r}")
    if num_workers > 1:
        files = shard_for_worker(files, num_workers, worker_index)
    return info, files


_PREPROCESS_REGISTRY = {
    "ron_320_vgg": PreprocessConfig(out_shape=(320, 320)),
    "ron_320_vgg_heavy": PreprocessConfig(out_shape=(320, 320)),
    "ssd_300_vgg": PreprocessConfig(out_shape=(300, 300)),
    "ssd_512_vgg": PreprocessConfig(out_shape=(512, 512)),
    "ron_tiny_vgg": PreprocessConfig(out_shape=(64, 64)),
}


def get_preprocessing(name: str, out_shape: Optional[Tuple[int, int]] = None) -> PreprocessConfig:
    """The augmentation config of a model name, its output shape replaced by
    `out_shape` when given (ref: preprocessing/preprocessing_factory.py:32-61)."""
    if name not in _PREPROCESS_REGISTRY:
        raise ValueError(f"unknown preprocessing {name!r}; options: {sorted(_PREPROCESS_REGISTRY)}")
    cfg = _PREPROCESS_REGISTRY[name]
    if out_shape is not None:
        cfg = dataclasses.replace(cfg, out_shape=tuple(out_shape))
    return cfg
