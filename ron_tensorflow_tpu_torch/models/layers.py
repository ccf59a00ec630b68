"""Shared NN building blocks, NCHW.

Port of `ron_tensorflow_tpu/models/layers.py`. Parameters stay float32
and are cast to the activation dtype at each call, as the flax modules do
(`param_dtype=float32`, `dtype=compute dtype`), so one module serves both
the f32 and the bf16 model.

Train mode is an explicit `train=False` argument of `forward`, passed down
as the JAX modules' `train=` is, never `nn.Module.training`: a module is
built with `training=True`, and every caller that never calls `.eval()`
would otherwise normalize with batch statistics.

Distribution (`shard_model`): every BatchNorm takes the mesh's data group
and normalizes over the global batch in train mode (sync-BN, JAX
`layers.py:84-88`'s `pmean`); the convs that the mesh's rules shard take
its model group, hold their out-channel slice of the kernel, bias and
BatchNorm, and gather the channels after their epilogue (BN, ReLU). A
per-channel BatchNorm on a sharded conv needs no model-axis collective.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import Group, all_reduce_sum, gather_channels, group_size, reduce_grad

BN_MOMENTUM = 0.997  # ref: nets/ron_vgg_320.py:618 (decay)
BN_EPSILON = 1e-5  # ref: nets/ron_vgg_320.py:619

# Process-wide `fast_normalize` for every BatchNorm, JAX's switch
# (`layers.py:27-37`); a module's own `fast_normalize` (`RON(bn_fast_normalize=)`,
# `TrainConfig.bn_fast_normalize`) turns it on for that model alone.
_BN_FAST_NORMALIZE = False


def set_bn_fast_normalize(enabled: bool) -> None:
    global _BN_FAST_NORMALIZE
    _BN_FAST_NORMALIZE = bool(enabled)


def _same_pads(size: int, kernel: int, stride: int, dilation: int) -> Tuple[int, int]:
    """(before, after) zero padding of XLA's 'SAME' along one axis."""
    eff = (kernel - 1) * dilation + 1
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


class BatchNorm(nn.Module):
    """slim.batch_norm(decay=0.997, epsilon=1e-5, scale=True), `layers.py:40-100`.

    Inference (`train=False`): one scale/shift computed in float32 from the
    running statistics and cast to the activation dtype (`layers.py:69-75`).

    Training: float32 (or wider) batch statistics `mean` and `mean2` over (B, H, W),
    biased `var = max(mean2 - mean^2, 0)`; gradients flow through both. The
    running statistics follow `ra = 0.997 ra + 0.003 stat`, in place, under
    `no_grad` (not `F.batch_norm`, whose running variance is the unbiased
    one and whose momentum is the complement). With `fast_normalize` (or
    `set_bn_fast_normalize(True)`) and a non-f32 activation, the normalize
    runs as one scale/shift in the activation dtype (`layers.py:27-37`);
    f32 ignores it. With a `data_group`, `[mean, mean2]` are averaged over
    the group's ranks in one all-reduce (their gradients summed back over
    it), so the statistics, and the running ones, are the global batch's on
    every rank."""

    def __init__(self, features: int, eps: float = BN_EPSILON, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.fast_normalize = False
        self.data_group: Group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train: bool = False):
        if not train:
            s = self.weight / torch.sqrt(self.running_var + self.eps)
            b = self.bias - self.running_mean * s
            return x * s.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x32.mean(dim=(0, 2, 3))
        mean2 = (x32 * x32).mean(dim=(0, 2, 3))
        if self.data_group is not None:
            stats = all_reduce_sum(torch.stack([mean, mean2]), self.data_group) / group_size(self.data_group)
            mean, mean2 = stats[0], stats[1]
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        if (self.fast_normalize or _BN_FAST_NORMALIZE) and x.dtype != torch.float32:
            s = self.weight / torch.sqrt(var + self.eps)
            b = self.bias - mean * s
            return x * s.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]
        y = (x32 - mean[:, None, None]) / torch.sqrt(var + self.eps)[:, None, None]
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)


def _check_padding(padding: str) -> None:
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def _window_pads(x, window, strides, dilation=(1, 1), padding: str = "SAME"):
    """F.pad's (left, right, top, bottom) of XLA's padding of x's H and W."""
    if padding == "VALID":
        return (0, 0, 0, 0)
    (pt, pb), (pl, pr) = (_same_pads(x.shape[d], window[i], strides[i], dilation[i]) for i, d in enumerate((2, 3)))
    return (pl, pr, pt, pb)


def conv2d(x, conv: nn.Conv2d, padding: str = "SAME"):
    """`conv`'s convolution of x (parameters cast to x's dtype) with XLA's
    'SAME' or 'VALID' padding: an uneven SAME pad (a stride-2 conv on an
    even side pads after only) is applied before the conv."""
    pl, pr, pt, pb = _window_pads(x, conv.kernel_size, conv.stride, conv.dilation, padding)
    if pt != pb or pl != pr:
        x = F.pad(x, (pl, pr, pt, pb))
        pt = pl = 0
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride, (pt, pl), conv.dilation, conv.groups)


class BareConv(nn.Conv2d):
    """flax `nn.Conv` alone (no BatchNorm, no activation), XLA 'SAME'
    padding: its kernel and bias sit at the module's own path
    (`name/kernel`), where `Conv` nests them under `name/conv`. flax's
    default init: lecun-normal kernel, zero bias. `groups` = flax's
    `feature_group_count` (the zoo's depthwise convs)."""

    def forward(self, x):
        return conv2d(x, self, "SAME")


class Dense(nn.Linear):
    """flax `nn.Dense` with float32 parameters computing in the activation
    dtype: weight [out, in] = the flax kernel [in, out] transposed.
    `kernel_init`: "lecun_normal" (flax's default) or "glorot_uniform"."""

    def __init__(self, in_features: int, features: int, kernel_init: str = "lecun_normal"):
        super().__init__(in_features, features)
        if kernel_init not in ("lecun_normal", "glorot_uniform"):
            raise ValueError(f"unknown kernel_init {kernel_init!r}")
        self.kernel_init = kernel_init

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def max_pool(x, window=(3, 3), strides=(1, 1), padding: str = "SAME"):
    """flax `nn.max_pool`: 'SAME' pads with -inf at `_same_pads`' (before,
    after), which on an even side at stride 2 is (0, 1), not
    `F.max_pool2d(padding=1)`'s (1, 1)."""
    _check_padding(padding)
    pads = _window_pads(x, window, strides, padding=padding)
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, window, strides)


def avg_pool(x, window=(3, 3), strides=(1, 1), padding: str = "SAME", count_include_pad: bool = True):
    """flax `nn.avg_pool`: the window's sum over the zero-padded map,
    divided by the window's size (`count_include_pad`, torchvision's
    semantics) or by the count of real entries in it (TF/Keras/slim), that
    division in float32 and cast back, as flax divides by float32 ones."""
    _check_padding(padding)
    pads = _window_pads(x, window, strides, padding=padding)
    total = F.avg_pool2d(F.pad(x, pads), window, strides, divisor_override=1)
    if count_include_pad:
        return total / (window[0] * window[1])
    ones = F.pad(torch.ones((1, 1, *x.shape[2:]), device=x.device), pads)
    counts = F.avg_pool2d(ones, window, strides, divisor_override=1)
    return (total / counts).to(x.dtype)


def global_mean(x):
    """Mean over H and W of an NCHW map, accumulated in float32 (or wider)
    and cast back to x's dtype (`jnp.mean` of bf16)."""
    return x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim=(2, 3)).to(x.dtype)


class Conv(nn.Module):
    """slim.conv2d equivalent: conv [+ BN] [+ ReLU], XLA's 'SAME' padding or
    none ('VALID').

    With `norm=True` the conv has no bias (slim drops it when a normalizer
    is set); its BatchNorm's epsilon is `bn_epsilon` (1e-3 in the zoo).
    `conv.weight` is OIHW. With a `model_group` (`shard_model`) the conv
    holds its slice of the output channels and returns them all, gathered
    after the epilogue; its input's gradient is summed over the group (each
    slice computes its share)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: Tuple[int, int] = (3, 3),
        strides: Tuple[int, int] = (1, 1),
        dilation: Tuple[int, int] = (1, 1),
        norm: bool = False,
        relu: bool = True,
        padding: str = "SAME",
        bn_epsilon: float = BN_EPSILON,
    ):
        super().__init__()
        _check_padding(padding)
        self.conv = nn.Conv2d(
            in_features, features, kernel, strides, dilation=dilation, bias=not norm
        )
        self.bn = BatchNorm(features, eps=bn_epsilon) if norm else None
        self.relu = relu
        self.padding = padding
        self.model_group: Group = None

    def forward(self, x, train: bool = False):
        if self.model_group is not None:
            x = reduce_grad(x, self.model_group)
        x = conv2d(x, self.conv, self.padding)
        if self.bn is not None:
            x = self.bn(x, train)
        x = F.relu(x) if self.relu else x
        return gather_channels(x, self.model_group)

    @torch.no_grad()
    def shard_(self, mesh) -> None:
        """Keep this model rank's slice of the output channels of the
        kernel, bias and BatchNorm (parameters and statistics), and gather
        over the mesh's model group in the forward."""
        from ..parallel.mesh import local_slice

        def cut(t):
            return local_slice(t, mesh).clone()

        c = self.conv
        c.weight = nn.Parameter(cut(c.weight))
        c.out_channels = c.weight.shape[0]
        if c.bias is not None:
            c.bias = nn.Parameter(cut(c.bias))
        if self.bn is not None:
            self.bn.weight = nn.Parameter(cut(self.bn.weight))
            self.bn.bias = nn.Parameter(cut(self.bn.bias))
            self.bn.running_mean = cut(self.bn.running_mean)
            self.bn.running_var = cut(self.bn.running_var)
        self.model_group = mesh.model_group


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


def max_pool_3x3_s1(x):
    """3x3/stride-1 SAME max pool (SSD's pool5, `ssd.py:194`): flax pads with
    -inf, as `F.max_pool2d`'s implicit padding does, so the map keeps its size."""
    return F.max_pool2d(x, 3, 1, padding=1)


class Dropout(nn.Module):
    """flax `nn.Dropout` in train mode: keep with probability 1 - rate and
    scale by 1 / (1 - rate), else 0; the identity when not training or at
    rate 0. The mask is drawn from `generator` (torch's default generator
    when None), on x's device."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, train: bool = False, generator: torch.Generator = None, rows=None):
        """rows: (offset, global batch) of a rank's rows: the mask is drawn
        for the whole global batch and cut to them, as one process draws it."""
        if not train or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        shape = x.shape if rows is None else (rows[1], *x.shape[1:])
        keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
        if rows is not None:
            keep = keep.narrow(0, rows[0], x.shape[0])
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class L2Normalization(nn.Module):
    """Channel-wise L2 normalization with a learnable per-channel scale
    (`layers.py:213-232`)."""

    def __init__(self, features: int, scale_init: float = 1.0):
        super().__init__()
        self.scale_init = float(scale_init)
        self.gamma = nn.Parameter(torch.full((features,), self.scale_init))

    def forward(self, x):
        x32 = x.float()
        norm = torch.sqrt(torch.sum(x32 * x32, dim=1, keepdim=True) + 1e-12)
        return (x32 / norm * self.gamma[:, None, None]).to(x.dtype)


def pad2d(x, pad: Sequence[int] = (0, 0)):
    """Symmetric spatial zero pad of an NCHW tensor."""
    return F.pad(x, (pad[1], pad[1], pad[0], pad[0]))


def _glorot_uniform_(weight, fan_in: int, fan_out: int, generator):
    """Drawn on the generator's device, then copied: the same values
    whatever device the weight lies on."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    device = generator.device if generator is not None else "cpu"
    draw = torch.empty(weight.shape, device=device).uniform_(-limit, limit, generator=generator)
    with torch.no_grad():
        weight.copy_(draw)


def _lecun_normal_(weight, fan_in: int, generator):
    """flax's default kernel init: a normal truncated at two deviations,
    scaled so that its variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    device = generator.device if generator is not None else "cpu"
    draw = torch.empty(weight.shape, device=device)
    torch.nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    with torch.no_grad():
        weight.copy_(draw)


def init_like_flax_(module: nn.Module, generator: torch.Generator = None) -> nn.Module:
    """Re-initialize `module`'s parameters as the flax modules do
    (`layers.py:125-136, 170-179, 227-232`): glorot-uniform conv kernels with
    fan in kh*kw*in and fan out kh*kw*out, lecun-normal kernels of the bare
    convs (fan in kh*kw*in per group) and of a `Dense` unless it asks for
    glorot-uniform (fan in in, fan out out), the 2x2 deconv's glorot on its
    [2, 2, in, out] kernel, zero biases, BN scale 1 and bias 0 and running
    statistics 0 and 1, an L2 normalization's scale at its initial value.
    Not `nn.Conv2d`'s default (kaiming) init. The module may lie on any
    device."""
    for m in module.modules():
        if isinstance(m, BareConv):
            _, in_c, kh, kw = m.weight.shape
            _lecun_normal_(m.weight, kh * kw * in_c, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, Dense):
            out_c, in_c = m.weight.shape
            if m.kernel_init == "glorot_uniform":
                _glorot_uniform_(m.weight, in_c, out_c, generator)
            else:
                _lecun_normal_(m.weight, in_c, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            out_c, in_c, kh, kw = m.weight.shape
            _glorot_uniform_(m.weight, kh * kw * in_c, kh * kw * out_c, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, ConvTranspose):
            in_c, out_c, kh, kw = m.weight.shape
            _glorot_uniform_(m.weight, kh * kw * in_c, kh * kw * out_c, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, L2Normalization):
            nn.init.constant_(m.gamma, m.scale_init)
    return module


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Distribute `model` over a `parallel.mesh.Mesh`, in place: every
    BatchNorm syncs its train-mode statistics over the data group; each
    conv whose kernel `partition_params` shards on 'model' (JAX's rules on
    the flax names) keeps its slice of the output channels. Block 1 (K-B)
    is never sharded. Call before building the optimizer state. The sliced
    tensors are then exactly those the rules shard, or this raises."""
    from ..parallel.mesh import sharded_names

    want = {k for k, v in sharded_names(model, mesh).items() if v}
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.data_group = mesh.data_group
    owners = set()
    for name, m in model.named_modules():
        if isinstance(m, Conv) and f"{name}.conv.weight" in want:
            m.shard_(mesh)
            owners.add(name)
    sliced = {n for n, _ in itertools.chain(model.named_parameters(), model.named_buffers())
              if n.rsplit(".", 2)[0] in owners}
    if sliced != want:
        raise AssertionError(f"sharded tensors differ from the rules': {sorted(sliced ^ want)}")
    return model
