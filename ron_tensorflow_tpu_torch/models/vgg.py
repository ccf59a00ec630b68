"""VGG backbones, NCHW, the VGG body RON shares with SSD, and the VGG
classifiers of the zoo.

Port of `ron_tensorflow_tpu/models/vgg.py`: `VGG16Backbone` in both fc
variants: 'reduced' (fc6 = 3x3 conv with dilation 3, 1024 channels; fc7 =
1x1, 1024) and 'heavy' (fc6 = 7x7 conv, 4096 channels; fc7 = 1x1, 4096;
`vgg.py:239-242`). Endpoints follow the reference's `block1..block7`
naming, each recorded before its pool: for a 320x320 input block4 = 40x40,
block5 = 20x20, block6/7 = 10x10.

SSD runs the same body with its convs at the top of its own module
(`models/ssd.py`), so the body is written once here over any module that
holds convs under these names (`add_vgg16_convs`, `vgg16_block1`,
`vgg16_body`).

The zoo's entries (ref: nets/vgg.py, nets/nets_factory.py:34-42):
`VGGBackbone` (vgg_a / vgg_16 / vgg_19 with either fc variant) and
`VGG16Classifier` (`VGG16Backbone` + global mean + a glorot-uniform dense
head). Neither fuses block 1, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import full_f32_convs
from ..kernels import fused_block1_supported, fused_vgg_block1
from .layers import Conv, Dense, global_mean, max_pool_2x2

# (name, in, out) of the plain 3x3 convs after block 1, in order; None = pool.
_BODY = (
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), None,
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), None,
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), None,
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512), None,
)
_ENDPOINT_BEFORE_POOL = ("block2", "block3", "block4", "block5")
_BLOCK2 = 3  # conv2_1, conv2_2 and pool2: the first entries of _BODY
# fc6/fc7 of each variant: (fc6 kernel, fc6 dilation, channels)
FC_VARIANTS = {"reduced": ((3, 3), (3, 3), 1024), "heavy": ((7, 7), (1, 1), 4096)}


def phase_output_kernel(w: torch.Tensor) -> torch.Tensor:
    """The phase-output form of a 3x3 stride-1 SAME conv (`vgg.py:49-70`):
    one 4x4 stride-2 conv whose 4*Co output channels are the four 2x2
    output phases, phase-major (group 2p+q holds phase (p, q)):

        out[o, 2i+p, 2j+q] = conv(x padded (1, 2), K, stride 2)[(2p+q)Co+o, i, j]
        with K[(2p+q)Co+o, :, a, b] = w[o, :, a-p, b-q]  (0 outside [0, 3))

    w [Co, Ci, 3, 3] -> K [4*Co, Ci, 4, 4]."""
    if w.shape[2:] != (3, 3):
        raise ValueError(f"phase-output transform implemented for 3x3 only, got {tuple(w.shape)}")
    return torch.cat([F.pad(w, (q, 1 - q, p, 1 - p)) for p in (0, 1) for q in (0, 1)], dim=0)


def s2d_block1(x, w1, b1, w2, b2, dtype: torch.dtype = torch.float32):
    """VGG block 1 (conv1_1 + ReLU + conv1_2 + ReLU + 2x2 max pool) with
    conv1_2 + pool1 computed as one phase-output stride-2 conv
    (`vgg.py:73-118`): x [B, Ci, H, W] (H, W even), w1 [64, Ci, 3, 3],
    w2 [64, 64, 3, 3] OIHW -> [B, 64, H/2, W/2], the post-pool1 map.

    conv1_1 is the plain conv. The phase conv reads conv1_1's output padded
    by (1, 2) on each side: the bottom and right pad rows feed only taps
    that are structural zeros or map to the original SAME pad, so the
    result equals the plain composition. Its bias is b2 tiled 4x; pool1's
    windows are the phase groups, so the pool is a max over them."""
    co = w2.shape[0]
    y = F.relu(F.conv2d(x.to(dtype), w1.to(dtype), b1.to(dtype), padding=1))
    k2 = phase_output_kernel(w2).to(dtype)
    y2 = F.relu(F.conv2d(F.pad(y, (1, 2, 1, 2)), k2, b2.repeat(4).to(dtype), stride=2))
    b, _, h, w = y2.shape
    return y2.reshape(b, 4, co, h, w).amax(dim=1)


def s2d_stem_supported(height: int, width: int) -> bool:
    """The phase-output stem needs even spatial sizes (a 2x2 phase grid)."""
    return height % 2 == 0 and width % 2 == 0


def check_block1_forms(fuse_block1: bool, s2d_stem: bool = False, remat_blocks12: bool = False) -> None:
    """JAX's guards (`vgg.py:180-186`): at most one form of block 1."""
    if fuse_block1 and s2d_stem:
        raise ValueError("fuse_block1 and s2d_stem are mutually exclusive")
    if remat_blocks12 and (fuse_block1 or s2d_stem):
        raise ValueError("remat_blocks12 applies to the plain block-1/2 path")


def add_vgg16_convs(module: nn.Module) -> None:
    """conv1_1 .. conv5_3 as children of `module`, under the flax names."""
    module.conv1_1 = Conv(3, 64)
    module.conv1_2 = Conv(64, 64)
    for spec in _BODY:
        if spec is not None:
            name, cin, cout = spec
            module.add_module(name, Conv(cin, cout))


def vgg16_block1(module: nn.Module, x, fuse: bool, s2d_stem: bool = False):
    """conv1_1 + conv1_2 + 2x2 pool of `module`'s convs; with `fuse`,
    through the fused CUDA kernel (`kernels/fused_conv_pool.py`; its plain
    version on the CPU), which computes in bf16 with the same parameters;
    with `s2d_stem`, through `s2d_block1` in x's dtype."""
    if s2d_stem:
        if not s2d_stem_supported(x.shape[2], x.shape[3]):
            raise ValueError(f"s2d_stem needs even spatial sizes, got {tuple(x.shape)}")
        c1, c2 = module.conv1_1.conv, module.conv1_2.conv
        return s2d_block1(x, c1.weight, c1.bias, c2.weight, c2.bias, dtype=x.dtype)
    if not fuse:
        return max_pool_2x2(module.conv1_2(module.conv1_1(x)))
    if not fused_block1_supported(x.shape[2], x.shape[3]):
        raise ValueError(f"fuse_block1 unsupported for input {tuple(x.shape)}")
    c1, c2 = module.conv1_1.conv, module.conv1_2.conv
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    return fused_vgg_block1(nhwc, c1.weight, c1.bias, c2.weight, c2.bias).permute(0, 3, 1, 2)


def vgg16_blocks12(module: nn.Module, x):
    """conv1_1 .. pool2 of `module`'s convs, plain, without endpoints."""
    x = max_pool_2x2(module.conv1_2(module.conv1_1(x)))
    return max_pool_2x2(module.conv2_2(module.conv2_1(x)))


def remat_blocks12(module: nn.Module, x):
    """`vgg16_blocks12` as one checkpointed span while autograd records:
    only its input is saved, and the backward recomputes the span under the
    cuDNN TF32 flag its forward ran with."""
    if not torch.is_grad_enabled():
        return vgg16_blocks12(module, x)
    tf32 = torch.backends.cudnn.allow_tf32

    def span(x):
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return vgg16_blocks12(module, x)
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    return checkpoint(span, x, use_reentrant=False)


def vgg16_body(module: nn.Module, x, last_pool: Callable = max_pool_2x2,
               from_block3: bool = False) -> Tuple[torch.Tensor, Dict]:
    """conv2_1 .. conv5_3 of `module` on block 1's pooled output (or
    conv3_1 .. conv5_3 on block 2's, `from_block3`): (the output of the last
    pool, endpoints block2 (or block3) .. block5). `last_pool` is pool5 (SSD
    keeps the map's size there)."""
    end_points = {}
    body = _BODY[_BLOCK2:] if from_block3 else _BODY
    pools = iter(_ENDPOINT_BEFORE_POOL[1:] if from_block3 else _ENDPOINT_BEFORE_POOL)
    for i, spec in enumerate(body):
        if spec is None:
            end_points[next(pools)] = x
            x = (last_pool if i == len(body) - 1 else max_pool_2x2)(x)
        else:
            x = getattr(module, spec[0])(x)
    return x, end_points


class VGG16Backbone(nn.Module):
    """VGG-16 feature extractor with the detection-style fc6/fc7 conv head.

    variant: 'reduced' or 'heavy' (`FC_VARIANTS`).
    fuse_block1: run conv1_1 + conv1_2 + pool1 as the fused CUDA kernel.
    s2d_stem: run them as `s2d_block1` (even spatial sizes only).
    remat_blocks12: recompute conv1_1 .. pool2 in the backward; no `block2`
    endpoint. At most one of the three is on.
    The `block1` endpoint is recorded only when `forward` is asked for it
    (the classifier's endpoints; no detection head reads it, and holding
    the full-resolution map would keep it alive through the forward)."""

    def __init__(self, fuse_block1: bool = False, variant: str = "reduced", s2d_stem: bool = False,
                 remat_blocks12: bool = False):
        super().__init__()
        if variant not in FC_VARIANTS:
            raise ValueError(f"unknown VGG variant {variant!r}")
        check_block1_forms(fuse_block1, s2d_stem, remat_blocks12)
        self.fuse_block1 = fuse_block1
        self.s2d_stem = s2d_stem
        self.remat_blocks12 = remat_blocks12
        self.variant = variant
        add_vgg16_convs(self)
        kernel, dilation, channels = FC_VARIANTS[variant]
        self.fc6 = Conv(512, channels, kernel=kernel, dilation=dilation)
        self.fc7 = Conv(channels, channels, kernel=(1, 1))

    def _block1(self, x):
        return vgg16_block1(self, x, self.fuse_block1, self.s2d_stem)

    def forward(self, x, block1_endpoint: bool = False) -> Dict[str, torch.Tensor]:
        """x: [B, 3, H, W] -> endpoints block2..block7 (NCHW) (block3..block7
        with `remat_blocks12`), and block1 with `block1_endpoint` (the plain
        form only, as in the JAX package)."""
        plain = not (self.fuse_block1 or self.s2d_stem or self.remat_blocks12)
        if block1_endpoint and plain:
            y = self.conv1_2(self.conv1_1(x))
            x, end_points = vgg16_body(self, max_pool_2x2(y))
            end_points = {"block1": y, **end_points}
        elif self.remat_blocks12:
            x, end_points = vgg16_body(self, remat_blocks12(self, x), from_block3=True)
        else:
            x, end_points = vgg16_body(self, self._block1(x))
        x = self.fc6(x)
        end_points["block6"] = x
        end_points["block7"] = self.fc7(x)
        return end_points


class VGGBackbone(nn.Module):
    """The VGG family of the classification zoo (`vgg.py:249`; ref:
    nets/vgg.py:49-244): convs per block vgg_a (VGG-11) (1, 1, 2, 2, 2),
    vgg_16 (2, 2, 3, 3, 3), vgg_19 (2, 2, 4, 4, 4), widths 64..512, each
    block's endpoint recorded before its 2x2 pool, then fc6/fc7 of
    `fc_variant`. Takes NCHW in the activation dtype, as `VGG16Backbone`."""

    COUNTS = {"vgg_a": (1, 1, 2, 2, 2), "vgg_16": (2, 2, 3, 3, 3), "vgg_19": (2, 2, 4, 4, 4)}

    def __init__(self, depth: str = "vgg_16", fc_variant: str = "reduced"):
        super().__init__()
        if depth not in self.COUNTS:
            raise ValueError(f"unknown VGG depth {depth!r}; options: {sorted(self.COUNTS)}")
        if fc_variant not in FC_VARIANTS:
            raise ValueError(f"unknown VGG variant {fc_variant!r}")
        self.depth = depth
        self.fc_variant = fc_variant
        cin = 3
        for blk, (n, f) in enumerate(zip(self.COUNTS[depth], (64, 128, 256, 512, 512)), start=1):
            for ci in range(n):
                self.add_module(f"conv{blk}_{ci + 1}", Conv(cin, f))
                cin = f
        kernel, dilation, channels = FC_VARIANTS[fc_variant]
        self.fc6 = Conv(512, channels, kernel=kernel, dilation=dilation)
        self.fc7 = Conv(channels, channels, kernel=(1, 1))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: [B, 3, H, W] -> endpoints block1..block7 (NCHW)."""
        end_points = {}
        for blk, n in enumerate(self.COUNTS[self.depth], start=1):
            for ci in range(n):
                x = getattr(self, f"conv{blk}_{ci + 1}")(x)
            end_points[f"block{blk}"] = x
            x = max_pool_2x2(x)
        x = self.fc6(x)
        end_points["block6"] = x
        end_points["block7"] = self.fc7(x)
        return end_points


class VGG16Classifier(nn.Module):
    """VGG-16 image classifier (`vgg.py:284`; ref: nets/vgg.py:110-173):
    `VGG16Backbone(variant)` under `backbone`, the global mean of block7
    (accumulated in float32), and a glorot-uniform dense head `logits`.
    Takes NHWC pixels; returns (logits [B, classes] in the activation dtype,
    as JAX's, endpoints block1..block7 in NHWC). Block 1 is not fused."""

    def __init__(self, num_classes: int = 1000, variant: str = "reduced", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = VGG16Backbone(variant=variant)
        self.logits = Dense(FC_VARIANTS[variant][2], num_classes, kernel_init="glorot_uniform")

    def forward(self, images, train: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """images [B, H, W, 3]; `train` changes nothing (no BatchNorm, no dropout)."""
        with full_f32_convs():
            end_points = self.backbone(images.to(self.dtype).permute(0, 3, 1, 2), block1_endpoint=True)
            logits = self.logits(global_mean(end_points["block7"]))
        return logits, {k: v.permute(0, 2, 3, 1) for k, v in end_points.items()}
