"""Box drawing / debug image dumps.

A copy of `ron_tensorflow_tpu/utils/visualization.py`; PIL is imported
where an image is drawn, so that importing this module needs no PIL.

Replaces the reference's cv2 drawing utilities (ref: draw_toolbox.py:48-101,
notebooks/visualization.py:86-114) and the `save_image_with_bbox` py_func
debug hook (ref: eval_ron_network.py:240-247) with PIL-based equivalents.
"""

from __future__ import annotations

import colorsys
import os
from typing import Optional, Sequence

import numpy as np

from ..data.voc import VOC_CLASSES


def class_colors(num_classes: int = 21):
    """Distinct hues per class (ref: draw_toolbox.py:29-45 colors_subselect)."""
    colors = []
    for i in range(num_classes):
        r, g, b = colorsys.hsv_to_rgb(i / max(num_classes, 1), 0.9, 0.9)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
    return colors


def draw_boxes(
    image01: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    scores: Optional[np.ndarray] = None,
    class_names: Sequence[str] = ("bg",) + VOC_CLASSES,
):
    """image01 [H,W,3] float [0,1]; boxes [N,4] normalized corner.
    Returns a PIL Image with drawn detections."""
    from PIL import Image, ImageDraw

    img = Image.fromarray((np.clip(image01, 0, 1) * 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    h, w = image01.shape[:2]
    colors = class_colors(len(class_names))
    for i in range(len(boxes)):
        label = int(labels[i])
        if label <= 0:
            continue
        ymin, xmin, ymax, xmax = boxes[i]
        color = colors[label % len(colors)]
        draw.rectangle(
            [xmin * w, ymin * h, xmax * w, ymax * h], outline=color, width=2
        )
        caption = class_names[label] if label < len(class_names) else str(label)
        if scores is not None:
            caption += f" {float(scores[i]):.2f}"
        draw.text((xmin * w + 2, ymin * h + 2), caption, fill=color)
    return img


def save_image_with_boxes(
    image01, boxes, labels, scores=None, directory: str = "./Debug", index: int = 0
) -> str:
    """Debug dump like the reference's ./Debug/<n>.jpg hook."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{index}.jpg")
    draw_boxes(np.asarray(image01), np.asarray(boxes), np.asarray(labels), scores).save(path)
    return path
