"""VOC -> TFRecord offline converter.

A copy of `ron_tensorflow_tpu/data/convert.py` (ref:
datasets/pascalvoc_to_tfrecords.py:70-230 + tf_convert_data.py:47-59): the
same record schema, the difficult/truncated attributes kept, 1500 samples
a shard by default. Its shards are byte for byte the JAX package's, and
readable by either framework.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

from . import example as pb
from .tfrecord import TFRecordWriter
from .voc import VocAnnotation, parse_annotation, voc_image_and_annotation_paths

SAMPLES_PER_FILE = 1500  # ref: pascalvoc_to_tfrecords.py SAMPLES_PER_FILES


def encode_voc_example(image_data: bytes, ann: VocAnnotation) -> bytes:
    """Build the serialized Example (ref: pascalvoc_to_tfrecords.py:128-169)."""
    ymin = [o.bbox[0] for o in ann.objects]
    xmin = [o.bbox[1] for o in ann.objects]
    ymax = [o.bbox[2] for o in ann.objects]
    xmax = [o.bbox[3] for o in ann.objects]
    features = {
        "image/height": pb.int64_feature(ann.shape[0]),
        "image/width": pb.int64_feature(ann.shape[1]),
        "image/channels": pb.int64_feature(ann.shape[2]),
        "image/shape": pb.int64_feature(list(ann.shape)),
        "image/object/bbox/xmin": pb.float_feature(xmin),
        "image/object/bbox/xmax": pb.float_feature(xmax),
        "image/object/bbox/ymin": pb.float_feature(ymin),
        "image/object/bbox/ymax": pb.float_feature(ymax),
        "image/object/bbox/label": pb.int64_feature([o.label for o in ann.objects]),
        "image/object/bbox/label_text": pb.bytes_feature([o.label_text.encode() for o in ann.objects]),
        "image/object/bbox/difficult": pb.int64_feature([o.difficult for o in ann.objects]),
        "image/object/bbox/truncated": pb.int64_feature([o.truncated for o in ann.objects]),
        "image/format": pb.bytes_feature(b"JPEG"),
        "image/encoded": pb.bytes_feature(image_data),
    }
    return pb.encode_example(features)


def convert_voc(
    voc_root: str,
    output_dir: str,
    output_name: str = "voc_2007_train",
    image_ids: Optional[List[str]] = None,
    shuffle_seed: Optional[int] = None,
    samples_per_file: int = SAMPLES_PER_FILE,
) -> int:
    """Convert a VOCdevkit year directory to TFRecord shards; returns the
    number of converted samples (ref: pascalvoc_to_tfrecords.py:191-230 `run`)."""
    os.makedirs(output_dir, exist_ok=True)
    if image_ids is None:
        ann_dir = os.path.join(voc_root, "Annotations")
        image_ids = sorted(os.path.splitext(n)[0] for n in os.listdir(ann_dir))
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(image_ids)

    count = 0
    writer = None
    shard = 0
    for name in image_ids:
        if count % samples_per_file == 0:
            if writer is not None:
                writer.close()
            writer = TFRecordWriter(os.path.join(output_dir, f"{output_name}_{shard:03d}.tfrecord"))
            shard += 1
        jpeg_path, xml_path = voc_image_and_annotation_paths(voc_root, name)
        with open(jpeg_path, "rb") as f:
            image_data = f.read()
        writer.write(encode_voc_example(image_data, parse_annotation(xml_path)))
        count += 1
    if writer is not None:
        writer.close()
    return count
