"""Eval preprocessing: VGG whitening and the warp resize.

Port of `whiten` and `eval_preprocess` from
`ron_tensorflow_tpu/data/preprocess.py`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .resize import tf1_bilinear_resize

# VGG means, RGB order (ref: ssd_vgg_preprocessing.py:41-44).
VGG_MEANS = (123.0, 117.0, 104.0)


def whiten(image01: torch.Tensor) -> torch.Tensor:
    """[0,1] float image -> VGG-whitened pixels (scale x255, subtract the
    means; ref: ssd_vgg_preprocessing.py:47-55)."""
    means = torch.tensor(VGG_MEANS, dtype=image01.dtype, device=image01.device)
    return image01 * 255.0 - means


def eval_preprocess(image01: torch.Tensor, out_shape: Tuple[int, int] = (320, 320)):
    """Whiten + warp resize with TF1 legacy-bilinear numerics (the
    reference's default Resize.WARP_RESIZE). image01 [H, W, 3] -> (the
    whitened [oh, ow, 3] image, the full-image reference box used to
    un-resize detections)."""
    img = tf1_bilinear_resize(image01, out_shape)
    bbox_img = torch.tensor([0.0, 0.0, 1.0, 1.0], device=img.device)
    return whiten(img), bbox_img
