"""Classification dataset definitions (cifar10 / imagenet).

A copy of `ron_tensorflow_tpu/data/classification.py` over the port's
`data/example.py` (ref: datasets/cifar10.py, datasets/imagenet.py,
dataset_factory.py:28-34, registered but unused by the detection
pipelines): the split metadata and a minimal image-classification Example
schema (image/encoded, image/format, image/class/label) in the slim
conventions, so that classification runs of the zoo's backbones read the
same TFRecord files.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import example as pb
from .voc import SplitInfo

CLASSIFICATION_SPLITS: Dict[str, Dict[str, SplitInfo]] = {
    # ref: datasets/cifar10.py:31-33
    "cifar10": {
        "train": SplitInfo("train", "cifar10_train_*.tfrecord", 50000),
        "test": SplitInfo("test", "cifar10_test_*.tfrecord", 10000),
    },
    # ref: datasets/imagenet.py:60-63
    "imagenet": {
        "train": SplitInfo("train", "imagenet_train_*.tfrecord", 1281167),
        "validation": SplitInfo("validation", "imagenet_validation_*.tfrecord", 50000),
    },
}


def encode_classification_example(image_data: bytes, label: int, fmt: bytes = b"JPEG") -> bytes:
    return pb.encode_example(
        {
            "image/encoded": pb.bytes_feature(image_data),
            "image/format": pb.bytes_feature(fmt),
            "image/class/label": pb.int64_feature(label),
        }
    )


def parse_classification_example(record: bytes) -> Dict:
    ex = pb.decode_example(record)
    return {
        "jpeg": ex["image/encoded"][0],
        "label": np.int32(ex["image/class/label"][0]),
    }
