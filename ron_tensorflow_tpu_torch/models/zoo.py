"""Classification backbone zoo: Inception-V3, Xception, Inception-ResNet-V2.

Port of `ron_tensorflow_tpu/models/zoo.py` (ref: nets/inception_v3.py,
nets/xception.py, nets/inception_resnet_v2.py, registered for
classification only). NCHW inside; each network takes NHWC pixels and
returns (logits float32 [B, classes], endpoints), the endpoints in the JAX
package's NHWC layout. Parameters stay float32 and are cast to `dtype` at
each call, as the flax modules' `param_dtype=float32`; the forward runs its
f32 convolutions in full f32 (`full_f32_convs`), as RON's does. Train mode
is `forward(x, train=True)`: BatchNorm on batch statistics, updating its
running ones.

Every module keeps its flax name, so `weights.from_jax_params` loads the
JAX package's variables (`mixed_5b.b0_1x1.conv.conv.weight` is
`mixed_5b/b0_1x1/conv/conv/kernel`). Numerics that follow the JAX modules:
the zoo's BatchNorm epsilon is 1e-3 (slim's inception arg scope,
torchvision's BasicConv2d); every 'SAME' pool pads as XLA does
(`layers.max_pool`, `layers.avg_pool`); Inception-V3's average pools count
the padding (torchvision), Inception-ResNet-V2's mixed_5b pool does not
(TF/Keras); the global mean accumulates in float32 and is cast back; the
dense head runs in the activation dtype and its logits are cast to
float32; residual sums are `x + scale * up` in the activation dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import full_f32_convs
from .layers import BareConv, BatchNorm, Conv, Dense, avg_pool, global_mean, max_pool

ZOO_BN_EPSILON = 1e-3  # slim inception arg scope, torchvision BasicConv2d


def _pool(x, kind="max", window=(3, 3), strides=(1, 1), padding="SAME", count_include_pad=True):
    """`zoo.py::_pool`: count_include_pad only matters for 'avg' with SAME
    padding (True: torchvision, False: TF/Keras/slim)."""
    if kind == "max":
        return max_pool(x, window, strides, padding)
    return avg_pool(x, window, strides, padding, count_include_pad)


def _nhwc(end_points: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.permute(0, 2, 3, 1) for k, v in end_points.items()}


class ConvBN(nn.Module):
    """conv + BN (epsilon 1e-3) + ReLU: the inception 'conv2d'."""

    def __init__(self, in_features: int, features: int, kernel=(3, 3), strides=(1, 1), padding="SAME"):
        super().__init__()
        self.conv = Conv(in_features, features, kernel, strides, norm=True, padding=padding,
                         bn_epsilon=ZOO_BN_EPSILON)

    def forward(self, x, train: bool = False):
        return self.conv(x, train)


class _Branches(nn.Module):
    """An inception block: ConvBN children made from (name, in, out, kernel[,
    strides, padding]) specs, run as chains of names."""

    def _add(self, specs):
        for name, cin, cout, kernel, *rest in specs:
            self.add_module(name, ConvBN(cin, cout, kernel, *rest))

    def _chain(self, x, names, train):
        for name in names:
            x = getattr(self, name)(x, train)
        return x


class InceptionA(_Branches):
    def __init__(self, in_features: int, pool_features: int):
        super().__init__()
        c = in_features
        self._add((("b0_1x1", c, 64, (1, 1)), ("b1_1x1", c, 48, (1, 1)), ("b1_5x5", 48, 64, (5, 5)),
                   ("b2_1x1", c, 64, (1, 1)), ("b2_3x3a", 64, 96, (3, 3)), ("b2_3x3b", 96, 96, (3, 3)),
                   ("b3_1x1", c, pool_features, (1, 1))))
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x, train: bool = False):
        return torch.cat([
            self._chain(x, ("b0_1x1",), train),
            self._chain(x, ("b1_1x1", "b1_5x5"), train),
            self._chain(x, ("b2_1x1", "b2_3x3a", "b2_3x3b"), train),
            self._chain(_pool(x, "avg"), ("b3_1x1",), train),
        ], dim=1)


class InceptionB(_Branches):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, in_features: int):
        super().__init__()
        c = in_features
        self._add((("b0_3x3", c, 384, (3, 3), (2, 2), "VALID"), ("b1_1x1", c, 64, (1, 1)),
                   ("b1_3x3a", 64, 96, (3, 3)), ("b1_3x3b", 96, 96, (3, 3), (2, 2), "VALID")))
        self.out_features = 384 + 96 + c

    def forward(self, x, train: bool = False):
        return torch.cat([
            self._chain(x, ("b0_3x3",), train),
            self._chain(x, ("b1_1x1", "b1_3x3a", "b1_3x3b"), train),
            _pool(x, "max", strides=(2, 2), padding="VALID"),
        ], dim=1)


class InceptionC(_Branches):
    def __init__(self, in_features: int, channels_7x7: int):
        super().__init__()
        c, c7 = in_features, channels_7x7
        self._add((("b0_1x1", c, 192, (1, 1)),
                   ("b1_1x1", c, c7, (1, 1)), ("b1_1x7", c7, c7, (1, 7)), ("b1_7x1", c7, 192, (7, 1)),
                   ("b2_1x1", c, c7, (1, 1)), ("b2_7x1a", c7, c7, (7, 1)), ("b2_1x7a", c7, c7, (1, 7)),
                   ("b2_7x1b", c7, c7, (7, 1)), ("b2_1x7b", c7, 192, (1, 7)),
                   ("b3_1x1", c, 192, (1, 1))))
        self.out_features = 4 * 192

    def forward(self, x, train: bool = False):
        return torch.cat([
            self._chain(x, ("b0_1x1",), train),
            self._chain(x, ("b1_1x1", "b1_1x7", "b1_7x1"), train),
            self._chain(x, ("b2_1x1", "b2_7x1a", "b2_1x7a", "b2_7x1b", "b2_1x7b"), train),
            self._chain(_pool(x, "avg"), ("b3_1x1",), train),
        ], dim=1)


class InceptionD(_Branches):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, in_features: int):
        super().__init__()
        c = in_features
        self._add((("b0_1x1", c, 192, (1, 1)), ("b0_3x3", 192, 320, (3, 3), (2, 2), "VALID"),
                   ("b1_1x1", c, 192, (1, 1)), ("b1_1x7", 192, 192, (1, 7)), ("b1_7x1", 192, 192, (7, 1)),
                   ("b1_3x3", 192, 192, (3, 3), (2, 2), "VALID")))
        self.out_features = 320 + 192 + c

    def forward(self, x, train: bool = False):
        return torch.cat([
            self._chain(x, ("b0_1x1", "b0_3x3"), train),
            self._chain(x, ("b1_1x1", "b1_1x7", "b1_7x1", "b1_3x3"), train),
            _pool(x, "max", strides=(2, 2), padding="VALID"),
        ], dim=1)


class InceptionE(_Branches):
    def __init__(self, in_features: int):
        super().__init__()
        c = in_features
        self._add((("b0_1x1", c, 320, (1, 1)),
                   ("b1_1x1", c, 384, (1, 1)), ("b1_1x3", 384, 384, (1, 3)), ("b1_3x1", 384, 384, (3, 1)),
                   ("b2_1x1", c, 448, (1, 1)), ("b2_3x3", 448, 384, (3, 3)),
                   ("b2_1x3", 384, 384, (1, 3)), ("b2_3x1", 384, 384, (3, 1)),
                   ("b3_1x1", c, 192, (1, 1))))
        self.out_features = 320 + 768 + 768 + 192

    def forward(self, x, train: bool = False):
        b1 = self._chain(x, ("b1_1x1",), train)
        b2 = self._chain(x, ("b2_1x1", "b2_3x3"), train)
        return torch.cat([
            self._chain(x, ("b0_1x1",), train),
            self._chain(b1, ("b1_1x3",), train), self._chain(b1, ("b1_3x1",), train),
            self._chain(b2, ("b2_1x3",), train), self._chain(b2, ("b2_3x1",), train),
            self._chain(_pool(x, "avg"), ("b3_1x1",), train),
        ], dim=1)


def _stem(module: nn.Module) -> None:
    """stem1..stem5 of Inception-V3 and Inception-ResNet-V2 (3 -> 192)."""
    module.stem1 = ConvBN(3, 32, (3, 3), (2, 2), "VALID")
    module.stem2 = ConvBN(32, 32, (3, 3), padding="VALID")
    module.stem3 = ConvBN(32, 64, (3, 3))
    module.stem4 = ConvBN(64, 80, (1, 1), padding="VALID")
    module.stem5 = ConvBN(80, 192, (3, 3), padding="VALID")


def _run_stem(module: nn.Module, x, train: bool):
    x = module.stem3(module.stem2(module.stem1(x, train), train), train)
    x = _pool(x, "max", strides=(2, 2), padding="VALID")
    x = module.stem5(module.stem4(x, train), train)
    return _pool(x, "max", strides=(2, 2), padding="VALID")


class _Classifier(nn.Module):
    """NHWC pixels in, the activation dtype inside, (float32 logits, NHWC endpoints) out."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def forward(self, images, train: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """images [B, H, W, 3]; train: BatchNorm on batch statistics."""
        with full_f32_convs():
            x, end_points = self._features(images.to(self.dtype).permute(0, 3, 1, 2), train)
            logits = self.logits(global_mean(x))
        return logits.float(), _nhwc(end_points)


class InceptionV3(_Classifier):
    """Inception-V3 classifier (`zoo.py:161`; ref: nets/inception_v3.py)."""

    def __init__(self, num_classes: int = 1001, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        _stem(self)
        c = 192
        for name, cls, arg in (("mixed_5b", InceptionA, 32), ("mixed_5c", InceptionA, 64),
                               ("mixed_5d", InceptionA, 64), ("mixed_6a", InceptionB, None),
                               ("mixed_6b", InceptionC, 128), ("mixed_6c", InceptionC, 160),
                               ("mixed_6d", InceptionC, 160), ("mixed_6e", InceptionC, 192),
                               ("mixed_7a", InceptionD, None), ("mixed_7b", InceptionE, None),
                               ("mixed_7c", InceptionE, None)):
            block = cls(c) if arg is None else cls(c, arg)
            self.add_module(name, block)
            c = block.out_features
        self.logits = Dense(c, num_classes)

    def _features(self, x, train):
        x = _run_stem(self, x, train)
        end_points = {"stem": x}
        for name in ("mixed_5b", "mixed_5c", "mixed_5d", "mixed_6a", "mixed_6b", "mixed_6c", "mixed_6d",
                     "mixed_6e", "mixed_7a", "mixed_7b", "mixed_7c"):
            x = getattr(self, name)(x, train)
            if name in ("mixed_5d", "mixed_6e", "mixed_7c"):
                end_points[name] = x
        return x, end_points


class SeparableConvBN(nn.Module):
    """Depthwise 3x3 (flax `feature_group_count=C`, weight [C, 1, 3, 3]) +
    pointwise 1x1, both without bias, + BN (epsilon 1e-3): the Xception
    primitive."""

    def __init__(self, in_features: int, features: int, kernel=(3, 3), strides=(1, 1)):
        super().__init__()
        self.depthwise = BareConv(in_features, in_features, kernel, strides, groups=in_features, bias=False)
        self.pointwise = BareConv(in_features, features, 1, bias=False)
        self.bn = BatchNorm(features, eps=ZOO_BN_EPSILON)

    def forward(self, x, train: bool = False):
        return self.bn(self.pointwise(self.depthwise(x)), train)


class XceptionBlock(nn.Module):
    """Two separable convs (ReLU before each; before the first only with
    `relu_first`), a 3x3 SAME max pool at `strides`, plus a strided 1x1
    conv + BN shortcut."""

    def __init__(self, in_features: int, features: int, strides=(2, 2), relu_first: bool = True):
        super().__init__()
        self.strides = tuple(strides)
        self.relu_first = relu_first
        self.shortcut = BareConv(in_features, features, 1, self.strides, bias=False)
        self.shortcut_bn = BatchNorm(features, eps=ZOO_BN_EPSILON)
        self.sep1 = SeparableConvBN(in_features, features)
        self.sep2 = SeparableConvBN(features, features)

    def forward(self, x, train: bool = False):
        res = self.shortcut_bn(self.shortcut(x), train)
        y = F.relu(x) if self.relu_first else x
        y = self.sep2(F.relu(self.sep1(y, train)), train)
        return max_pool(y, (3, 3), self.strides, "SAME") + res


class Xception(_Classifier):
    """Xception classifier (`zoo.py:248`; ref: nets/xception.py)."""

    def __init__(self, num_classes: int = 1000, middle_blocks: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.middle_blocks = middle_blocks
        self.entry1 = ConvBN(3, 32, (3, 3), (2, 2), "VALID")
        self.entry2 = ConvBN(32, 64, (3, 3), padding="VALID")
        self.entry_block1 = XceptionBlock(64, 128, relu_first=False)
        self.entry_block2 = XceptionBlock(128, 256)
        self.entry_block3 = XceptionBlock(256, 728)
        for i in range(middle_blocks):
            for j in range(3):
                self.add_module(f"middle{i + 1}_sep{j + 1}", SeparableConvBN(728, 728))
        self.exit_shortcut = BareConv(728, 1024, 1, 2, bias=False)
        self.exit_shortcut_bn = BatchNorm(1024, eps=ZOO_BN_EPSILON)
        self.exit_sep1 = SeparableConvBN(728, 728)
        self.exit_sep2 = SeparableConvBN(728, 1024)
        self.exit_sep3 = SeparableConvBN(1024, 1536)
        self.exit_sep4 = SeparableConvBN(1536, 2048)
        self.logits = Dense(2048, num_classes)

    def _features(self, x, train):
        x = self.entry2(self.entry1(x, train), train)
        for name in ("entry_block1", "entry_block2", "entry_block3"):
            x = getattr(self, name)(x, train)
        end_points = {"entry": x}
        for i in range(self.middle_blocks):
            y = x
            for j in range(3):
                y = getattr(self, f"middle{i + 1}_sep{j + 1}")(F.relu(y), train)
            x = y + x
        end_points["middle"] = x
        res = self.exit_shortcut_bn(self.exit_shortcut(x), train)
        y = self.exit_sep2(F.relu(self.exit_sep1(F.relu(x), train)), train)
        x = max_pool(y, (3, 3), (2, 2), "SAME") + res
        x = F.relu(self.exit_sep4(F.relu(self.exit_sep3(x, train)), train))
        end_points["exit"] = x
        return x, end_points


# kind -> (branches: (name, out, kernel) chains from the block's input, mixed width)
_RESNET_BLOCKS = {
    "block35": ((("b0", 32, (1, 1)),), (("b1a", 32, (1, 1)), ("b1b", 32, (3, 3))),
                (("b2a", 32, (1, 1)), ("b2b", 48, (3, 3)), ("b2c", 64, (3, 3)))),
    "block17": ((("b0", 192, (1, 1)),), (("b1a", 128, (1, 1)), ("b1b", 160, (1, 7)), ("b1c", 192, (7, 1)))),
    "block8": ((("b0", 192, (1, 1)),), (("b1a", 192, (1, 1)), ("b1b", 224, (1, 3)), ("b1c", 256, (3, 1)))),
}


class InceptionResnetBlock(nn.Module):
    """Scaled residual inception block (block35 / block17 / block8):
    `x + scale * up(concat(branches))`, then ReLU unless `activation=False`
    (the final block8 of the reference net, at scale 1)."""

    def __init__(self, kind: str, in_features: int, scale: float = 0.17, activation: bool = True):
        super().__init__()
        if kind not in _RESNET_BLOCKS:
            raise ValueError(f"unknown block kind {kind!r}")
        self.kind = kind
        self.scale = float(scale)
        self.activation = activation
        self.chains = []
        mixed = 0
        for chain in _RESNET_BLOCKS[kind]:
            c = in_features
            for name, out, kernel in chain:
                self.add_module(name, ConvBN(c, out, kernel))
                c = out
            self.chains.append(tuple(name for name, _, _ in chain))
            mixed += c
        self.up = BareConv(mixed, in_features, 1, bias=True)

    def forward(self, x, train: bool = False):
        branches = []
        for names in self.chains:
            y = x
            for name in names:
                y = getattr(self, name)(y, train)
            branches.append(y)
        out = x + self.scale * self.up(torch.cat(branches, dim=1))
        return F.relu(out) if self.activation else out


class InceptionResnetV2(_Classifier):
    """Inception-ResNet-V2 classifier with configurable depth (`zoo.py:338`;
    ref: nets/inception_resnet_v2.py)."""

    def __init__(self, num_classes: int = 1001, blocks35: int = 10, blocks17: int = 20, blocks8: int = 9,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.blocks = (blocks35, blocks17, blocks8)
        _stem(self)
        for name, cin, cout, kernel in (("m5b_b0", 192, 96, (1, 1)), ("m5b_b1a", 192, 48, (1, 1)),
                                        ("m5b_b1b", 48, 64, (5, 5)), ("m5b_b2a", 192, 64, (1, 1)),
                                        ("m5b_b2b", 64, 96, (3, 3)), ("m5b_b2c", 96, 96, (3, 3)),
                                        ("m5b_b3", 192, 64, (1, 1))):
            self.add_module(name, ConvBN(cin, cout, kernel))
        for i in range(blocks35):
            self.add_module(f"block35_{i + 1}", InceptionResnetBlock("block35", 320, 0.17))
        self.ra_b0 = ConvBN(320, 384, (3, 3), (2, 2), "VALID")
        self.ra_b1a = ConvBN(320, 256, (1, 1))
        self.ra_b1b = ConvBN(256, 256, (3, 3))
        self.ra_b1c = ConvBN(256, 384, (3, 3), (2, 2), "VALID")
        for i in range(blocks17):
            self.add_module(f"block17_{i + 1}", InceptionResnetBlock("block17", 1088, 0.10))
        self.rb_b0a = ConvBN(1088, 256, (1, 1))
        self.rb_b0b = ConvBN(256, 384, (3, 3), (2, 2), "VALID")
        self.rb_b1a = ConvBN(1088, 256, (1, 1))
        self.rb_b1b = ConvBN(256, 288, (3, 3), (2, 2), "VALID")
        self.rb_b2a = ConvBN(1088, 256, (1, 1))
        self.rb_b2b = ConvBN(256, 288, (3, 3))
        self.rb_b2c = ConvBN(288, 320, (3, 3), (2, 2), "VALID")
        for i in range(blocks8):
            self.add_module(f"block8_{i + 1}", InceptionResnetBlock("block8", 2080, 0.20))
        self.block8_final = InceptionResnetBlock("block8", 2080, 1.0, activation=False)
        self.conv7b = ConvBN(2080, 1536, (1, 1))
        self.logits = Dense(1536, num_classes)

    def _features(self, x, train):
        def run(y, *names):
            for name in names:
                y = getattr(self, name)(y, train)
            return y

        x = _run_stem(self, x, train)
        # mixed_5b; its pool excludes the padding from the mean (TF/slim/Keras)
        x = torch.cat([run(x, "m5b_b0"), run(x, "m5b_b1a", "m5b_b1b"), run(x, "m5b_b2a", "m5b_b2b", "m5b_b2c"),
                       run(_pool(x, "avg", count_include_pad=False), "m5b_b3")], dim=1)
        blocks35, blocks17, blocks8 = self.blocks
        x = run(x, *(f"block35_{i + 1}" for i in range(blocks35)))
        end_points = {"block35": x}
        x = torch.cat([run(x, "ra_b0"), run(x, "ra_b1a", "ra_b1b", "ra_b1c"),
                       _pool(x, "max", strides=(2, 2), padding="VALID")], dim=1)
        x = run(x, *(f"block17_{i + 1}" for i in range(blocks17)))
        end_points["block17"] = x
        x = torch.cat([run(x, "rb_b0a", "rb_b0b"), run(x, "rb_b1a", "rb_b1b"), run(x, "rb_b2a", "rb_b2b", "rb_b2c"),
                       _pool(x, "max", strides=(2, 2), padding="VALID")], dim=1)
        x = run(x, *(f"block8_{i + 1}" for i in range(blocks8)), "block8_final", "conv7b")
        end_points["conv7b"] = x
        return x, end_points
