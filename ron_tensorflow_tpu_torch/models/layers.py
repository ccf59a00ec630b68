"""Shared NN building blocks for inference, NCHW.

Port of `ron_tensorflow_tpu/models/layers.py`. Parameters stay float32
and are cast to the activation dtype at each call, as the flax modules do
(`param_dtype=float32`, `dtype=compute dtype`), so one module serves both
the f32 and the bf16 model.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPSILON = 1e-5  # ref: nets/ron_vgg_320.py:619


def _same_pads(size: int, kernel: int, stride: int, dilation: int) -> Tuple[int, int]:
    """(before, after) zero padding of XLA's 'SAME' along one axis."""
    eff = (kernel - 1) * dilation + 1
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


class BatchNorm(nn.Module):
    """Inference BatchNorm folded to one scale/shift, as `layers.py:69-75`:
    the scale and shift are computed in float32 and cast to the activation
    dtype."""

    def __init__(self, features: int, eps: float = BN_EPSILON):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        s = self.weight / torch.sqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * s
        return x * s.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


class Conv(nn.Module):
    """slim.conv2d equivalent: conv [+ BN] [+ ReLU], SAME padding.

    With `norm=True` the conv has no bias (slim drops it when a normalizer
    is set). `conv.weight` is OIHW."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: Tuple[int, int] = (3, 3),
        strides: Tuple[int, int] = (1, 1),
        dilation: Tuple[int, int] = (1, 1),
        norm: bool = False,
        relu: bool = True,
    ):
        super().__init__()
        self.conv = nn.Conv2d(
            in_features, features, kernel, strides, dilation=dilation, bias=not norm
        )
        self.bn = BatchNorm(features) if norm else None
        self.relu = relu

    def forward(self, x):
        c = self.conv
        (pt, pb), (pl, pr) = (
            _same_pads(x.shape[d], c.kernel_size[i], c.stride[i], c.dilation[i])
            for i, d in enumerate((2, 3))
        )
        if pt != pb or pl != pr:
            x = F.pad(x, (pl, pr, pt, pb))
            pt = pl = 0
        bias = None if c.bias is None else c.bias.to(x.dtype)
        x = F.conv2d(
            x, c.weight.to(x.dtype), bias, c.stride, (pt, pl), c.dilation
        )
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class ConvTranspose(nn.Module):
    """2x2/stride-2 transposed conv + bias + ReLU (the reverse connection's
    deconv, `layers.py:151-198`).

    `weight` is in `F.conv_transpose2d`'s [in, out, 2, 2] layout: output
    pixel (2y+dy, 2x+dx) is `weight[:, :, dy, dx]` applied to input (y, x).
    The flax kernel [2, 2, in, out] is stored with its taps flipped
    (`layers.py:180-189`), so `weights.from_jax_params` maps
    weight[c, o, dy, dx] = kernel[1-dy, 1-dx, c, o]."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_features, features, 2, 2))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=2)
        return F.relu(y)


def max_pool_2x2(x):
    """2x2/stride-2 SAME max pool: on an odd map SAME pads the end, which
    is `ceil_mode=True`."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class L2Normalization(nn.Module):
    """Channel-wise L2 normalization with a learnable per-channel scale
    (`layers.py:213-232`)."""

    def __init__(self, features: int, scale_init: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((features,), float(scale_init)))

    def forward(self, x):
        x32 = x.float()
        norm = torch.sqrt(torch.sum(x32 * x32, dim=1, keepdim=True) + 1e-12)
        return (x32 / norm * self.gamma[:, None, None]).to(x.dtype)


def pad2d(x, pad: Sequence[int] = (0, 0)):
    """Symmetric spatial zero pad of an NCHW tensor."""
    return F.pad(x, (pad[1], pad[1], pad[0], pad[0]))
