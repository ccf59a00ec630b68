"""RON detector: reduced VGG-16 + reverse connections + objectness priors.

Port of `ron_tensorflow_tpu/models/ron.py`. Inside, tensors are NCHW; the
outputs keep the JAX package's layout: each head is flattened NHWC as
(y, x, anchor), layers coarse to fine (block7, block6, block5, block4),
concatenated to [B, N_total, ...] and cast to float32 (`ron.py:226-233`).
An NCHW head output must be permuted to NHWC before that reshape, or the
anchor order breaks without any error.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import full_f32_convs
from .layers import BatchNorm, Conv, ConvTranspose
from .spec import RON_320_SPEC, DetectorSpec
from .vgg import FC_VARIANTS, VGG16Backbone


def _endpoint_channels(variant: str) -> dict:
    """Backbone channels of each endpoint a reverse connection reads:
    block6 and block7 carry the fc variant's width (1024 reduced, 4096 heavy)."""
    fc = FC_VARIANTS[variant][2]
    return {"block4": 512, "block5": 512, "block6": fc, "block7": fc}


class DetectorOutputs(NamedTuple):
    """Flat all-layer head outputs, [B, N_total, ...], float32."""

    predictions: torch.Tensor  # [B, N, C] softmax class probabilities
    logits: torch.Tensor  # [B, N, C]
    objness_pred: torch.Tensor  # [B, N] P(object)
    objness_logits: torch.Tensor  # [B, N, 2]
    locations: torch.Tensor  # [B, N, 4] (cx, cy, w, h) offsets


def _flatten_head(x, last: int):
    """[B, A*last, H, W] -> [B, H*W*A, last] in (y, x, anchor) order."""
    b = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(b, -1, last)


class ClsHead(nn.Module):
    """Two inception-style {3x3, 1x1}-concat-BN blocks, then a 3x3
    predictor (ref: nets/ron_vgg_320.py:378-404)."""

    def __init__(self, num_anchors: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.inception1_3x3 = Conv(512, 512, relu=False)
        self.inception1_1x1 = Conv(512, 512, kernel=(1, 1), relu=False)
        self.inception1_bn = BatchNorm(1024)
        self.inception2_3x3 = Conv(1024, 512, relu=False)
        self.inception2_1x1 = Conv(1024, 512, kernel=(1, 1), relu=False)
        self.inception2_bn = BatchNorm(1024)
        self.pred = Conv(1024, num_anchors * num_classes, relu=False)

    def forward(self, x, train: bool = False):
        for blk in ("inception1", "inception2"):
            x = torch.cat(
                [getattr(self, f"{blk}_3x3")(x), getattr(self, f"{blk}_1x1")(x)], dim=1
            )
            x = F.relu(getattr(self, f"{blk}_bn")(x, train))
        return _flatten_head(self.pred(x), self.num_classes)


class BoxHead(nn.Module):
    """3x3 conv(512, BN, ReLU) + 3x3 predictor -> [B, H*W*A, 4]
    (ref: nets/ron_vgg_320.py:406-415)."""

    def __init__(self, num_anchors: int):
        super().__init__()
        self.conv = Conv(512, 512, norm=True)
        self.pred = Conv(512, 4 * num_anchors, relu=False)

    def forward(self, x, train: bool = False):
        return _flatten_head(self.pred(self.conv(x, train)), 4)


class ObjectnessHead(nn.Module):
    """3x3 conv(512, BN, ReLU) + 3x3 2A-way predictor -> [B, H*W*A, 2]
    (ref: nets/ron_vgg_320.py:428-430)."""

    def __init__(self, num_anchors: int):
        super().__init__()
        self.conv = Conv(512, 512, norm=True)
        self.score = Conv(512, 2 * num_anchors, relu=False)

    def forward(self, x, train: bool = False):
        return _flatten_head(self.score(self.conv(x, train)), 2)


class ReverseConnection(nn.Module):
    """Top-down reverse connection producing a 512-channel map
    (ref: nets/ron_vgg_320.py:418-432).

    First (coarsest) layer: strided 2x2 conv (BN, ReLU) of the backbone
    feature. Others: 3x3 conv (BN, ReLU) of the lateral feature plus the
    ReLU'd 2x2 deconv of the map above, summed, ReLU."""

    def __init__(self, in_features: int, first: bool):
        super().__init__()
        if first:
            self.conv_left = Conv(in_features, 512, kernel=(2, 2), strides=(2, 2), norm=True)
            self.deconv_right = None
        else:
            self.conv_left = Conv(in_features, 512, norm=True)
            self.deconv_right = ConvTranspose(512, 512)

    def forward(self, left, right=None, train: bool = False):
        if self.deconv_right is None:
            return self.conv_left(left, train)
        return F.relu(self.conv_left(left, train) + self.deconv_right(right))


class RON(nn.Module):
    """The RON detector (ref: nets/ron_vgg_320.py:434-580 `ron_net_reducedfc`).

    backbone_variant: the VGG fc variant, 'reduced' or 'heavy'.
    dtype: compute dtype; parameters stay float32 and are cast per call.
    fuse_block1: run VGG block 1 through the fused CUDA kernel.
    s2d_stem: run it as the phase-output stem (`vgg.s2d_block1`).
    remat_blocks12: recompute VGG blocks 1-2 in the backward.
    At most one of these three is on (`vgg.check_block1_forms`).
    bn_fast_normalize: in train mode, normalize a bf16 activation with one
    scale/shift in bf16 (`BatchNorm.fast_normalize`; `TrainConfig`'s
    `bn_fast_normalize`)."""

    def __init__(
        self,
        spec: DetectorSpec = RON_320_SPEC,
        dtype: torch.dtype = torch.float32,
        fuse_block1: bool = False,
        bn_fast_normalize: bool = False,
        backbone_variant: str = "reduced",
        s2d_stem: bool = False,
        remat_blocks12: bool = False,
    ):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.backbone = VGG16Backbone(fuse_block1=fuse_block1, variant=backbone_variant, s2d_stem=s2d_stem,
                                      remat_blocks12=remat_blocks12)
        channels = _endpoint_channels(backbone_variant)
        for i, layer in enumerate(spec.feat_layers):
            a = spec.num_anchors_per_cell(i)
            self.add_module(
                f"{layer}_reverse", ReverseConnection(channels[layer], first=i == 0)
            )
            self.add_module(f"{layer}_objectness", ObjectnessHead(a))
            self.add_module(f"{layer}_cls", ClsHead(a, spec.num_classes))
            self.add_module(f"{layer}_box", BoxHead(a))
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.fast_normalize = bn_fast_normalize

    def forward(self, images, train: bool = False) -> DetectorOutputs:
        """images: [B, H, W, 3] whitened (VGG mean-subtracted) pixels.
        train: BatchNorm on batch statistics, updating its running ones.

        The forward's convolutions run in full f32 for an f32 model, whatever
        the caller's TF32 flag: under torch's default (cuDNN TF32 on) the f32
        detections leave the reference's 2e-3 gate (PERF.md, Findings). The
        backward runs outside this block: `train.state.make_train_step` pins
        it."""
        with full_f32_convs():
            return self._forward(images, train)

    def _forward(self, images, train: bool) -> DetectorOutputs:
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        end_points = self.backbone(x)
        logits_l, objl_l, locs_l = [], [], []
        ref_map = None
        for layer in self.spec.feat_layers:
            ref_map = getattr(self, f"{layer}_reverse")(end_points[layer], ref_map, train)
            objl_l.append(getattr(self, f"{layer}_objectness")(ref_map, train))
            logits_l.append(getattr(self, f"{layer}_cls")(ref_map, train))
            locs_l.append(getattr(self, f"{layer}_box")(ref_map, train))
        logits = torch.cat(logits_l, dim=1).float()
        objness_logits = torch.cat(objl_l, dim=1).float()
        locations = torch.cat(locs_l, dim=1).float()
        return DetectorOutputs(
            predictions=torch.softmax(logits, dim=-1),
            logits=logits,
            objness_pred=torch.softmax(objness_logits, dim=-1)[..., 1],
            objness_logits=objness_logits,
            locations=locations,
        )
