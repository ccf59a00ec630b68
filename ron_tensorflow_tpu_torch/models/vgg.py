"""Reduced VGG-16 backbone, NCHW.

Port of `ron_tensorflow_tpu/models/vgg.py::VGG16Backbone` (variant
'reduced': fc6 = 3x3 conv with dilation 3, 1024 channels; fc7 = 1x1,
1024). Endpoints follow the reference's `block1..block7` naming, each
recorded before its pool: for a 320x320 input block4 = 40x40,
block5 = 20x20, block6/7 = 10x10.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..kernels import fused_block1_supported, fused_vgg_block1
from .layers import Conv, max_pool_2x2

# (name, in, out) of the plain 3x3 convs after block 1, in order; None = pool.
_BODY = (
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), None,
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), None,
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), None,
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512), None,
)
_ENDPOINT_BEFORE_POOL = ("block2", "block3", "block4", "block5")


class VGG16Backbone(nn.Module):
    """VGG-16 feature extractor with the reduced fc6/fc7 conv head.

    fuse_block1: run conv1_1 + conv1_2 + pool1 as the fused CUDA kernel
    (`kernels/fused_conv_pool.py`; its plain version on the CPU). Same
    parameters. The kernel computes in bf16. The `block1` endpoint is not
    recorded on either path: no head reads it."""

    def __init__(self, fuse_block1: bool = False):
        super().__init__()
        self.fuse_block1 = fuse_block1
        self.conv1_1 = Conv(3, 64)
        self.conv1_2 = Conv(64, 64)
        for spec in _BODY:
            if spec is not None:
                name, cin, cout = spec
                self.add_module(name, Conv(cin, cout))
        self.fc6 = Conv(512, 1024, dilation=(3, 3))
        self.fc7 = Conv(1024, 1024, kernel=(1, 1))

    def _block1(self, x):
        if not self.fuse_block1:
            return max_pool_2x2(self.conv1_2(self.conv1_1(x)))
        if not fused_block1_supported(x.shape[2], x.shape[3]):
            raise ValueError(f"fuse_block1 unsupported for input {tuple(x.shape)}")
        c1, c2 = self.conv1_1.conv, self.conv1_2.conv
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        return fused_vgg_block1(nhwc, c1.weight, c1.bias, c2.weight, c2.bias).permute(0, 3, 1, 2)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: [B, 3, H, W] -> endpoints block2..block7 (NCHW)."""
        end_points = {}
        x = self._block1(x)
        pools = iter(_ENDPOINT_BEFORE_POOL)
        for spec in _BODY:
            if spec is None:
                end_points[next(pools)] = x
                x = max_pool_2x2(x)
            else:
                x = getattr(self, spec[0])(x)
        x = self.fc6(x)
        end_points["block6"] = x
        end_points["block7"] = self.fc7(x)
        return end_points
