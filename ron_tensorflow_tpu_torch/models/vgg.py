"""VGG-16 backbone, NCHW, and the VGG body it shares with SSD.

Port of `ron_tensorflow_tpu/models/vgg.py::VGG16Backbone`, both fc
variants: 'reduced' (fc6 = 3x3 conv with dilation 3, 1024 channels; fc7 =
1x1, 1024) and 'heavy' (fc6 = 7x7 conv, 4096 channels; fc7 = 1x1, 4096;
`vgg.py:239-242`). Endpoints follow the reference's `block1..block7`
naming, each recorded before its pool: for a 320x320 input block4 = 40x40,
block5 = 20x20, block6/7 = 10x10.

SSD runs the same body with its convs at the top of its own module
(`models/ssd.py`), so the body is written once here over any module that
holds convs under these names (`add_vgg16_convs`, `vgg16_block1`,
`vgg16_body`).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

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
# fc6/fc7 of each variant: (fc6 kernel, fc6 dilation, channels)
FC_VARIANTS = {"reduced": ((3, 3), (3, 3), 1024), "heavy": ((7, 7), (1, 1), 4096)}


def add_vgg16_convs(module: nn.Module) -> None:
    """conv1_1 .. conv5_3 as children of `module`, under the flax names."""
    module.conv1_1 = Conv(3, 64)
    module.conv1_2 = Conv(64, 64)
    for spec in _BODY:
        if spec is not None:
            name, cin, cout = spec
            module.add_module(name, Conv(cin, cout))


def vgg16_block1(module: nn.Module, x, fuse: bool):
    """conv1_1 + conv1_2 + 2x2 pool of `module`'s convs; with `fuse`,
    through the fused CUDA kernel (`kernels/fused_conv_pool.py`; its plain
    version on the CPU), which computes in bf16 with the same parameters."""
    if not fuse:
        return max_pool_2x2(module.conv1_2(module.conv1_1(x)))
    if not fused_block1_supported(x.shape[2], x.shape[3]):
        raise ValueError(f"fuse_block1 unsupported for input {tuple(x.shape)}")
    c1, c2 = module.conv1_1.conv, module.conv1_2.conv
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    return fused_vgg_block1(nhwc, c1.weight, c1.bias, c2.weight, c2.bias).permute(0, 3, 1, 2)


def vgg16_body(module: nn.Module, x, last_pool: Callable = max_pool_2x2) -> Tuple[torch.Tensor, Dict]:
    """conv2_1 .. conv5_3 of `module` on block 1's pooled output: (the
    output of the last pool, endpoints block2..block5). `last_pool` is pool5
    (SSD keeps the map's size there)."""
    end_points = {}
    pools = iter(_ENDPOINT_BEFORE_POOL)
    for i, spec in enumerate(_BODY):
        if spec is None:
            end_points[next(pools)] = x
            x = (last_pool if i == len(_BODY) - 1 else max_pool_2x2)(x)
        else:
            x = getattr(module, spec[0])(x)
    return x, end_points


class VGG16Backbone(nn.Module):
    """VGG-16 feature extractor with the detection-style fc6/fc7 conv head.

    variant: 'reduced' or 'heavy' (`FC_VARIANTS`).
    fuse_block1: run conv1_1 + conv1_2 + pool1 as the fused CUDA kernel.
    The `block1` endpoint is not recorded on either path: no head reads it."""

    def __init__(self, fuse_block1: bool = False, variant: str = "reduced"):
        super().__init__()
        if variant not in FC_VARIANTS:
            raise ValueError(f"unknown VGG variant {variant!r}")
        self.fuse_block1 = fuse_block1
        self.variant = variant
        add_vgg16_convs(self)
        kernel, dilation, channels = FC_VARIANTS[variant]
        self.fc6 = Conv(512, channels, kernel=kernel, dilation=dilation)
        self.fc7 = Conv(channels, channels, kernel=(1, 1))

    def _block1(self, x):
        return vgg16_block1(self, x, self.fuse_block1)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: [B, 3, H, W] -> endpoints block2..block7 (NCHW)."""
        x, end_points = vgg16_body(self, self._block1(x))
        x = self.fc6(x)
        end_points["block6"] = x
        end_points["block7"] = self.fc7(x)
        return end_points
