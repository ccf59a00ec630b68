"""RON and SSD forwards in plain PyTorch, NCHW inside, from a configuration
file's sizes and a dict of weights.

Weights are named as the PyTorch modules of the published architectures
name them (`backbone.conv1_1.conv.weight`, `block7_reverse.conv_left.bn.
running_mean`, `block4_box.l2_norm.gamma`), convolution kernels OIHW and
the 2x2 transposed convolution [in, out, 2, 2]. Padding follows
TensorFlow's 'SAME' rule of the published graphs; BatchNorm runs on its
running statistics (epsilon 1e-5), or with `train` on the batch's
(biased variance over batch, height and width), as slim's batch_norm
trains. `quant`, where given, is applied to
every convolution's input and kernel: the control of the benchmark's
comparison runs the reference through it in a lower precision.

`Net.flops` counts the multiply-adds of one image's convolutions as two
operations each; over an empty batch it counts without computing.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPSILON = 1e-5


def same_pads(size: int, kernel: int, stride: int, dilation: int) -> Tuple[int, int]:
    """(before, after) zero padding of TensorFlow's 'SAME' along one axis."""
    eff = (kernel - 1) * dilation + 1
    total = max((math.ceil(size / stride) - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


class Params:
    """Weights by name. With `tensors` None it hands out stand-ins of the
    right shape (one zero, broadcast) and records each name's (shape,
    kind): the parameter list of a configuration, read off its forward
    over an empty batch."""

    def __init__(self, tensors: Optional[Dict[str, torch.Tensor]] = None):
        self.tensors = tensors
        self.spec: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def __call__(self, name: str, shape, kind: str) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        self.spec[name] = (shape, kind)
        if self.tensors is None:
            return torch.zeros(()).expand(shape)
        t = self.tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: weight of shape {tuple(t.shape)}, the configuration needs {shape}")
        return t


class Net:
    """The layers of both detectors over one `Params`."""

    def __init__(self, params: Params, quant: Optional[Callable] = None, train: bool = False):
        self.p = params
        self.q = quant if quant is not None else (lambda t: t)
        self.train = train
        self.flops = 0

    def bn(self, name: str, x):
        c = x.shape[1]
        w, b = self.p(f"{name}.weight", (c,), "bn_scale"), self.p(f"{name}.bias", (c,), "bn_bias")
        mean, var = self.p(f"{name}.running_mean", (c,), "bn_mean"), self.p(f"{name}.running_var", (c,), "bn_var")
        if self.train and x.shape[0]:
            mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
        s = w / torch.sqrt(var + BN_EPSILON)
        return x * s[:, None, None] + (b - mean * s)[:, None, None]

    def conv(self, name: str, x, cout: int, k: int = 3, stride: int = 1, dilation: int = 1, same: bool = True,
             norm: bool = False, relu: bool = True):
        """Conv [+ BatchNorm] [+ ReLU]; a conv followed by BatchNorm has no bias."""
        cin = x.shape[1]
        w = self.p(f"{name}.conv.weight", (cout, cin, k, k), "kernel")
        b = None if norm else self.p(f"{name}.conv.bias", (cout,), "bias")
        if same:
            (pt, pb), (pl, pr) = (same_pads(x.shape[d], k, stride, dilation) for d in (2, 3))
            x = F.pad(x, (pl, pr, pt, pb))
        y = F.conv2d(self.q(x), self.q(w), b, stride, 0, dilation)
        self.flops += 2 * math.prod(y.shape[1:]) * cin * k * k
        if norm:
            y = self.bn(f"{name}.bn", y)
        return F.relu(y) if relu else y

    def deconv(self, name: str, x, cout: int):
        """2x2 stride-2 transposed conv + bias + ReLU."""
        cin = x.shape[1]
        w = self.p(f"{name}.weight", (cin, cout, 2, 2), "deconv_kernel")
        b = self.p(f"{name}.bias", (cout,), "bias")
        y = F.conv_transpose2d(self.q(x), self.q(w), b, stride=2)
        self.flops += 2 * math.prod(x.shape[1:]) * cout * 4
        return F.relu(y)

    def l2_norm(self, name: str, x, scale: float):
        gamma = self.p(f"{name}.gamma", (x.shape[1],), f"gamma:{scale}")
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-12)
        return x / norm * gamma[:, None, None]


def pool2(x):
    """2x2 stride-2 'SAME' max pool: an odd side pads its end."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


VGG16 = ((("conv1_1", 64), ("conv1_2", 64)), (("conv2_1", 128), ("conv2_2", 128)),
         (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
         (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
         (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)))


def vgg16(net: Net, x, prefix: str, pool5: Callable):
    """VGG-16's 13 convs: -> (pool5's output, endpoints block1..block5, each before its pool)."""
    ends = {}
    for i, block in enumerate(VGG16, start=1):
        for name, c in block:
            x = net.conv(prefix + name, x, c)
        ends[f"block{i}"] = x
        x = (pool5 if i == 5 else pool2)(x)
    return x, ends


def anchors_per_cell(cfg: dict, i: int) -> int:
    sizes, ratios = cfg["anchor_sizes"][i], cfg["anchor_ratios"][i]
    return len(sizes) * len(ratios) if cfg["anchor_style"] == "ron" else len(sizes) + len(ratios)


def flatten_head(x, last: int):
    """[B, A*last, H, W] -> [B, H*W*A, last] in (y, x, anchor) order."""
    b, _, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w * (x.shape[1] // last), last)


def ron_forward(net: Net, images, cfg: dict) -> Dict[str, torch.Tensor]:
    """RON (ref: ron_vgg_320.py `ron_net_reducedfc`): VGG-16 with the fc6/fc7
    conv head, reverse connections from the coarsest feature layer down, and
    objectness, class and box heads on each connection's map."""
    x, ends = vgg16(net, images.permute(0, 3, 1, 2), "backbone.", pool2)
    fc6 = cfg["fc6"]
    ends["block6"] = x = net.conv("backbone.fc6", x, fc6["channels"], k=fc6["kernel"], dilation=fc6["dilation"])
    ends["block7"] = net.conv("backbone.fc7", x, fc6["channels"], k=1)
    c = cfg["num_classes"]
    logits, objl, locs, ref = [], [], [], None
    for i, layer in enumerate(cfg["feat_layers"]):
        a = anchors_per_cell(cfg, i)
        if ref is None:
            ref = net.conv(f"{layer}_reverse.conv_left", ends[layer], 512, k=2, stride=2, norm=True)
        else:
            left = net.conv(f"{layer}_reverse.conv_left", ends[layer], 512, norm=True)
            ref = F.relu(left + net.deconv(f"{layer}_reverse.deconv_right", ref, 512))
        o = net.conv(f"{layer}_objectness.conv", ref, 512, norm=True)
        objl.append(flatten_head(net.conv(f"{layer}_objectness.score", o, 2 * a, relu=False), 2))
        h = ref
        for blk in ("inception1", "inception2"):
            h = torch.cat([net.conv(f"{layer}_cls.{blk}_3x3", h, 512, relu=False),
                           net.conv(f"{layer}_cls.{blk}_1x1", h, 512, k=1, relu=False)], dim=1)
            h = F.relu(net.bn(f"{layer}_cls.{blk}_bn", h))
        logits.append(flatten_head(net.conv(f"{layer}_cls.pred", h, a * c, relu=False), c))
        bx = net.conv(f"{layer}_box.conv", ref, 512, norm=True)
        locs.append(flatten_head(net.conv(f"{layer}_box.pred", bx, 4 * a, relu=False), 4))
    return {"logits": torch.cat(logits, 1), "objness_logits": torch.cat(objl, 1), "locations": torch.cat(locs, 1)}


def ssd_forward(net: Net, images, cfg: dict) -> Dict[str, torch.Tensor]:
    """SSD (ref: ssd_vgg_300.py): VGG-16 with a 3x3 stride-1 pool5, conv6
    (dilation 6) and conv7, the extra blocks (1x1 bottleneck, then a 3x3
    conv: stride 2 after a one-pixel pad, or stride 1 unpadded), an L2
    normalization before the layers that ask for one, and a 3x3 class and
    location predictor on each feature layer. The objectness is 1."""
    x, ends = vgg16(net, images.permute(0, 3, 1, 2), "", lambda t: F.max_pool2d(t, 3, 1, padding=1))
    ends["block6"] = x = net.conv("conv6", x, 1024, dilation=6)
    ends["block7"] = x = net.conv("conv7", x, 1024, k=1)
    for name, bottleneck, features, strided in cfg["extra_blocks"]:
        x = net.conv(f"{name}.conv1x1", x, bottleneck, k=1)
        if strided:
            x = net.conv(f"{name}.conv3x3", F.pad(x, (1, 1, 1, 1)), features, stride=2, same=False)
        else:
            x = net.conv(f"{name}.conv3x3", x, features, same=False)
        ends[name] = x
    c = cfg["num_classes"]
    logits, locs = [], []
    for i, layer in enumerate(cfg["feat_layers"]):
        a, x = anchors_per_cell(cfg, i), ends[layer]
        if cfg["normalizations"][i] > 0:
            x = net.l2_norm(f"{layer}_box.l2_norm", x, cfg["normalizations"][i])
        logits.append(flatten_head(net.conv(f"{layer}_box.conv_cls", x, a * c, relu=False), c))
        locs.append(flatten_head(net.conv(f"{layer}_box.conv_loc", x, 4 * a, relu=False), 4))
    logits = torch.cat(logits, 1)
    ones = torch.ones(logits.shape[:2], device=logits.device, dtype=logits.dtype)
    return {"logits": logits, "objness_logits": torch.stack([torch.zeros_like(ones), ones * 1e3], -1),
            "locations": torch.cat(locs, 1)}


FORWARDS = {"ron": ron_forward, "ssd": ssd_forward}


def heads(cfg: dict, weights: Dict[str, torch.Tensor], images, quant: Optional[Callable] = None,
          train: bool = False):
    """The configuration's forward on whitened NHWC images: logits, objectness
    logits and locations, and the class and objectness probabilities."""
    out = FORWARDS[cfg["arch"]](Net(Params(weights), quant, train), images, cfg)
    out["predictions"] = torch.softmax(out["logits"], -1)
    out["objness_pred"] = torch.softmax(out["objness_logits"], -1)[..., 1]
    return out


def param_spec(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{name: (shape, kind)} of the configuration's weights."""
    p = Params()
    h, w = cfg["img_shape"]
    FORWARDS[cfg["arch"]](Net(p), torch.empty((0, h, w, 3)), cfg)
    return p.spec


def flops_per_image(cfg: dict) -> int:
    """Operations of one image's forward: two for each multiply-add of every
    convolution (the elementwise work, the softmax and the pools are left
    out)."""
    net = Net(Params())
    h, w = cfg["img_shape"]
    FORWARDS[cfg["arch"]](net, torch.empty((0, h, w, 3)), cfg)
    return net.flops

