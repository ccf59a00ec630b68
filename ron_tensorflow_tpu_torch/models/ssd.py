"""SSD-300/512 detectors, NCHW inside, the JAX layout at the outputs.

Port of `ron_tensorflow_tpu/models/ssd.py` (ref: nets/ssd_vgg_300.py:82-531,
nets/ssd_vgg_512.py:77-607): the VGG-16 body with its convs at the top of
the module (no `backbone` scope; the fc layers are `conv6`, dilation 6, and
`conv7`), a 3x3/stride-1 pool5, dropout after conv6 and conv7 in train
mode, the extra blocks 8-11 (and 12 for SSD-512), an L2 normalization
(scale 20) before block4's head, and one multibox head per feature layer
(no ReLU). Parameter names are the JAX package's flat ones: `conv1_1` ..
`conv7`, `block8`..`block12` (`conv1x1`, `conv3x3` or `conv4x4`),
`block12_conv1x1`, `block12_conv4x4` and `<layer>_box` (`l2_norm`,
`conv_loc`, `conv_cls`).

The outputs follow RON's flat [B, N_total, ...] contract with a constant
objectness (1, its logits [0, 1e3]), so the detection heads serve both.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import full_f32_convs
from .layers import Conv, Dropout, L2Normalization, max_pool_3x3_s1, pad2d
from .ron import DetectorOutputs, _flatten_head
from .spec import SSD_300_SPEC, DetectorSpec
from .vgg import add_vgg16_convs, vgg16_block1, vgg16_body

# Channels of each feature layer a multibox head reads.
_FEATURE_CHANNELS = {"block4": 512, "block7": 1024, "block8": 512, "block9": 256, "block10": 256,
                     "block11": 256, "block12": 256}


class MultiboxHead(nn.Module):
    """Class and location predictors of one feature layer, 3x3 convs without
    ReLU, after an optional L2 normalization (ref: nets/ssd_vgg_300.py:403-431)
    -> (logits [B, H*W*A, C], locations [B, H*W*A, 4]) in (y, x, anchor) order."""

    def __init__(self, in_features: int, num_anchors: int, num_classes: int, normalization: float = -1.0):
        super().__init__()
        self.num_classes = num_classes
        self.l2_norm = L2Normalization(in_features, normalization) if normalization > 0 else None
        self.conv_loc = Conv(in_features, 4 * num_anchors, relu=False)
        self.conv_cls = Conv(in_features, num_anchors * num_classes, relu=False)

    def forward(self, x):
        if self.l2_norm is not None:
            x = self.l2_norm(x)
        return _flatten_head(self.conv_cls(x), self.num_classes), _flatten_head(self.conv_loc(x), 4)


class SSDExtraBlock(nn.Module):
    """1x1 bottleneck (ReLU), then a 3x3 conv (ReLU): stride 2 after a
    one-pixel zero pad, or stride 1 without padding (VALID)
    (ref: nets/ssd_vgg_300.py:487-508, ssd_vgg_512.py:410-441)."""

    def __init__(self, in_features: int, bottleneck: int, features: int, strided: bool = True):
        super().__init__()
        self.strided = strided
        self.conv1x1 = Conv(in_features, bottleneck, kernel=(1, 1))
        self.conv3x3 = Conv(bottleneck, features, strides=(2, 2) if strided else (1, 1), padding="VALID")

    def forward(self, x):
        x = self.conv1x1(x)
        return self.conv3x3(pad2d(x, (1, 1)) if self.strided else x)


class SSD(nn.Module):
    """The SSD detector, 300 or 512 by its spec.

    dropout_rate: of the two train-mode dropouts (after conv6 and conv7).
    dtype: compute dtype; parameters stay float32 and are cast per call.
    fuse_block1: run VGG block 1 through the fused CUDA kernel (K-B)."""

    def __init__(
        self,
        spec: DetectorSpec = SSD_300_SPEC,
        dtype: torch.dtype = torch.float32,
        fuse_block1: bool = False,
        dropout_rate: float = 0.5,
    ):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.fuse_block1 = fuse_block1
        self.is_512 = spec.name == "ssd_512_vgg"
        add_vgg16_convs(self)
        self.conv6 = Conv(512, 1024, dilation=(6, 6))
        self.conv7 = Conv(1024, 1024, kernel=(1, 1))
        self.dropout = Dropout(dropout_rate)
        self.block8 = SSDExtraBlock(1024, 256, 512)
        self.block9 = SSDExtraBlock(512, 128, 256)
        self.block10 = SSDExtraBlock(256, 128, 256, strided=self.is_512)
        self.block11 = SSDExtraBlock(256, 128, 256, strided=self.is_512)
        if self.is_512:  # pad + 4x4 VALID (ref: ssd_vgg_512.py:434-441)
            self.block12_conv1x1 = Conv(256, 128, kernel=(1, 1))
            self.block12_conv4x4 = Conv(128, 256, kernel=(4, 4), padding="VALID")
        for i, layer in enumerate(spec.feat_layers):
            self.add_module(f"{layer}_box", MultiboxHead(
                _FEATURE_CHANNELS[layer], spec.num_anchors_per_cell(i), spec.num_classes, spec.normalizations[i]))

    def forward(self, images, train: bool = False, generator: torch.Generator = None, rows=None) -> DetectorOutputs:
        """images: [B, H, W, 3] whitened pixels. train: the dropouts drop,
        their masks drawn from `generator`, for the whole global batch and
        cut to `rows` = (offset, global batch) when the images are a rank's
        rows of one. An f32 model runs its forward's convolutions in full
        f32 whatever the caller's TF32 flag, as RON's."""
        with full_f32_convs():
            return self._forward(images, train, generator, rows)

    def _forward(self, images, train: bool, generator, rows) -> DetectorOutputs:
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x, end_points = vgg16_body(self, vgg16_block1(self, x, self.fuse_block1), last_pool=max_pool_3x3_s1)
        x = self.conv6(x)
        end_points["block6"] = x
        x = self.conv7(self.dropout(x, train, generator, rows))
        end_points["block7"] = x
        x = self.dropout(x, train, generator, rows)
        for name in ("block8", "block9", "block10", "block11"):
            x = getattr(self, name)(x)
            end_points[name] = x
        if self.is_512:
            end_points["block12"] = self.block12_conv4x4(pad2d(self.block12_conv1x1(x), (1, 1)))

        logits_l, locs_l = [], []
        for layer in self.spec.feat_layers:
            cls, loc = getattr(self, f"{layer}_box")(end_points[layer])
            logits_l.append(cls)
            locs_l.append(loc)
        logits = torch.cat(logits_l, dim=1).float()
        locations = torch.cat(locs_l, dim=1).float()
        ones = torch.ones(logits.shape[:2], device=logits.device)
        return DetectorOutputs(
            predictions=torch.softmax(logits, dim=-1),
            logits=logits,
            objness_pred=ones,  # SSD has no objectness prior
            objness_logits=torch.stack([torch.zeros_like(ones), ones * 1e3], dim=-1),
            locations=locations,
        )
