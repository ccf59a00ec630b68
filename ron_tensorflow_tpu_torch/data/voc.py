"""Pascal VOC dataset definitions: label map, split metadata, XML parsing.

A copy of `ron_tensorflow_tpu/data/voc.py` (standard library only): the
label map, `SplitInfo` and the split registry `SPLITS` (read by
`data/factory.py::get_dataset`), `VocObject`, `VocAnnotation`,
`parse_annotation` and `voc_image_and_annotation_paths`.

(ref: datasets/pascalvoc_common.py:24-53 label registry,
datasets/pascalvoc_2007.py:78-81 / pascalvoc_2007_2012.py:79-82 split sizes,
datasets/pascalvoc_to_tfrecords.py:70-125 XML annotation parsing — including
the 'difficult attribute kept' fix, README.md:27.)
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

VOC_LABELS: Dict[str, Tuple[int, str]] = {
    "none": (0, "Background"),
    "aeroplane": (1, "Vehicle"),
    "bicycle": (2, "Vehicle"),
    "bird": (3, "Animal"),
    "boat": (4, "Vehicle"),
    "bottle": (5, "Indoor"),
    "bus": (6, "Vehicle"),
    "car": (7, "Vehicle"),
    "cat": (8, "Animal"),
    "chair": (9, "Indoor"),
    "cow": (10, "Animal"),
    "diningtable": (11, "Indoor"),
    "dog": (12, "Animal"),
    "horse": (13, "Animal"),
    "motorbike": (14, "Vehicle"),
    "person": (15, "Person"),
    "pottedplant": (16, "Indoor"),
    "sheep": (17, "Animal"),
    "sofa": (18, "Indoor"),
    "train": (19, "Vehicle"),
    "tvmonitor": (20, "Indoor"),
}

VOC_CLASSES: Tuple[str, ...] = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

NUM_CLASSES = 21  # background + 20


@dataclasses.dataclass(frozen=True)
class SplitInfo:
    name: str
    file_pattern: str  # fnmatch pattern over shard filenames
    num_samples: int


# Split registry (ref: pascalvoc_2007.py:20-23,78-81;
# pascalvoc_2007_2012.py:22,79-82; pascalvoc_2012.py:76-82).
SPLITS: Dict[str, Dict[str, SplitInfo]] = {
    "pascalvoc_2007": {
        "train": SplitInfo("train", "voc_2007_train_*.tfrecord", 5011),
        "test": SplitInfo("test", "voc_2007_test_*.tfrecord", 4952),
    },
    "pascalvoc_2012": {
        "train": SplitInfo("train", "voc_2012_train_*.tfrecord", 17125),
    },
    "pascalvoc_2007_2012": {
        "train": SplitInfo("train", "voc_20??_train_*.tfrecord", 22136),
    },
}


@dataclasses.dataclass
class VocObject:
    label: int
    label_text: str
    bbox: Tuple[float, float, float, float]  # normalized (ymin, xmin, ymax, xmax)
    difficult: int
    truncated: int


@dataclasses.dataclass
class VocAnnotation:
    shape: Tuple[int, int, int]
    objects: List[VocObject]


def parse_annotation(xml_path: str) -> VocAnnotation:
    """Parse one VOC Annotation XML into normalized boxes
    (ref: datasets/pascalvoc_to_tfrecords.py:84-125)."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    shape = (
        int(size.find("height").text),
        int(size.find("width").text),
        int(size.find("depth").text),
    )
    objects: List[VocObject] = []
    for obj in root.findall("object"):
        label_text = obj.find("name").text
        label, _ = VOC_LABELS[label_text]
        diff_node = obj.find("difficult")
        trunc_node = obj.find("truncated")
        bbox = obj.find("bndbox")
        objects.append(
            VocObject(
                label=label,
                label_text=label_text,
                bbox=(
                    float(bbox.find("ymin").text) / shape[0],
                    float(bbox.find("xmin").text) / shape[1],
                    float(bbox.find("ymax").text) / shape[0],
                    float(bbox.find("xmax").text) / shape[1],
                ),
                difficult=int(diff_node.text) if diff_node is not None else 0,
                truncated=int(trunc_node.text) if trunc_node is not None else 0,
            )
        )
    return VocAnnotation(shape=shape, objects=objects)


def voc_image_and_annotation_paths(voc_root: str, name: str) -> Tuple[str, str]:
    """(jpeg path, xml path) for an image id inside a VOCdevkit year dir."""
    return (
        os.path.join(voc_root, "JPEGImages", name + ".jpg"),
        os.path.join(voc_root, "Annotations", name + ".xml"),
    )
