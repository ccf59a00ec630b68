"""Seeded weights for tests and smoke runs: numpy draws under the flax
names, so that one set of numbers loads into the port's model
(`weights.from_jax_params`) and into the JAX package's (`unflatten_params`).
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import numpy as np
import torch

from ..weights import jax_names, to_jax_layout


def seeded_flax_params(model: torch.nn.Module, seed: int, gain: float = 1.0, bn_mean_std: float = 0.1
                       ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(params, batch stats) of `model` as float32 numpy arrays in the flax
    layout, keyed by flax path, drawn from `np.random.default_rng(seed)`:
    conv, deconv and dense kernels N(0, gain^2 / fan_in) (fan_in = kh * kw *
    in, in for a dense kernel; gain 1 keeps a linear layer's output at its
    input's scale, sqrt(2) a ReLU layer's), biases N(0, 0.1), BatchNorm
    scales U(0.5, 1.5), L2 normalization scales U(10, 30), BatchNorm means
    N(0, bn_mean_std^2) and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    names = jax_names(model)
    params, stats = {}, {}
    for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
        path = names[name]
        shape = to_jax_layout(path, t).shape
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("kernel", "deconv_kernel"):
            v = rng.normal(0.0, gain / np.sqrt(np.prod(shape[:-1])), shape)
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "gamma":
            v = rng.uniform(10.0, 30.0, shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "mean":
            v = rng.normal(0.0, bn_mean_std, shape)
        else:  # biases
            v = rng.normal(0.0, 0.1, shape)
        (stats if leaf in ("mean", "var") else params)[path] = v.astype(np.float32)
    return params, stats


@torch.no_grad()
def scale_ssd_heads(model: torch.nn.Module, images: torch.Tensor, logit_std: float = 2.5,
                    loc_std: float = 0.5) -> None:
    """Scale each multibox head of an SSD `model`, in place, so that its
    logits and its locations on `images` ([B, H, W, 3] whitened, on the
    model's device) have these standard deviations. The heads are linear (no
    ReLU), so scaling a head's weight and bias scales its output exactly.
    Seeded weights through SSD's ~20 layers without BatchNorm otherwise give
    logits far from a useful scale: near-flat softmaxes, whose top-k order is
    a coin toss between two implementations, or one-hot ones."""
    spec = model.spec
    sizes = [h * w * spec.num_anchors_per_cell(i) for i, (h, w) in enumerate(spec.feat_shapes)]
    out = model(images)
    for layer, logits, locs in zip(spec.feat_layers, out.logits.split(sizes, 1), out.locations.split(sizes, 1)):
        head = getattr(model, f"{layer}_box")
        for conv, value, target in ((head.conv_cls.conv, logits, logit_std), (head.conv_loc.conv, locs, loc_std)):
            scale = target / float(value.std())
            conv.weight.mul_(scale)
            conv.bias.mul_(scale)


def _torchvision_inception_v3_convs():
    """(module name, in, out, (kh, kw)) of every BasicConv2d of torchvision's
    `inception_v3` (`torchvision/models/inception.py`), in its order, the
    auxiliary head included."""
    convs = [("Conv2d_1a_3x3", 3, 32, (3, 3)), ("Conv2d_2a_3x3", 32, 32, (3, 3)), ("Conv2d_2b_3x3", 32, 64, (3, 3)),
             ("Conv2d_3b_1x1", 64, 80, (1, 1)), ("Conv2d_4a_3x3", 80, 192, (3, 3))]

    def a(i, pool):
        return [("branch1x1", i, 64, (1, 1)), ("branch5x5_1", i, 48, (1, 1)), ("branch5x5_2", 48, 64, (5, 5)),
                ("branch3x3dbl_1", i, 64, (1, 1)), ("branch3x3dbl_2", 64, 96, (3, 3)),
                ("branch3x3dbl_3", 96, 96, (3, 3)), ("branch_pool", i, pool, (1, 1))]

    def b(i):
        return [("branch3x3", i, 384, (3, 3)), ("branch3x3dbl_1", i, 64, (1, 1)), ("branch3x3dbl_2", 64, 96, (3, 3)),
                ("branch3x3dbl_3", 96, 96, (3, 3))]

    def c(i, c7):
        return [("branch1x1", i, 192, (1, 1)), ("branch7x7_1", i, c7, (1, 1)), ("branch7x7_2", c7, c7, (1, 7)),
                ("branch7x7_3", c7, 192, (7, 1)), ("branch7x7dbl_1", i, c7, (1, 1)),
                ("branch7x7dbl_2", c7, c7, (7, 1)), ("branch7x7dbl_3", c7, c7, (1, 7)),
                ("branch7x7dbl_4", c7, c7, (7, 1)), ("branch7x7dbl_5", c7, 192, (1, 7)),
                ("branch_pool", i, 192, (1, 1))]

    def d(i):
        return [("branch3x3_1", i, 192, (1, 1)), ("branch3x3_2", 192, 320, (3, 3)),
                ("branch7x7x3_1", i, 192, (1, 1)), ("branch7x7x3_2", 192, 192, (1, 7)),
                ("branch7x7x3_3", 192, 192, (7, 1)), ("branch7x7x3_4", 192, 192, (3, 3))]

    def e(i):
        return [("branch1x1", i, 320, (1, 1)), ("branch3x3_1", i, 384, (1, 1)), ("branch3x3_2a", 384, 384, (1, 3)),
                ("branch3x3_2b", 384, 384, (3, 1)), ("branch3x3dbl_1", i, 448, (1, 1)),
                ("branch3x3dbl_2", 448, 384, (3, 3)), ("branch3x3dbl_3a", 384, 384, (1, 3)),
                ("branch3x3dbl_3b", 384, 384, (3, 1)), ("branch_pool", i, 192, (1, 1))]

    blocks = [("Mixed_5b", a(192, 32)), ("Mixed_5c", a(256, 64)), ("Mixed_5d", a(288, 64)), ("Mixed_6a", b(288)),
              ("Mixed_6b", c(768, 128)), ("Mixed_6c", c(768, 160)), ("Mixed_6d", c(768, 160)),
              ("Mixed_6e", c(768, 192)), ("AuxLogits", [("conv0", 768, 128, (1, 1)), ("conv1", 128, 768, (5, 5))]),
              ("Mixed_7a", d(768)), ("Mixed_7b", e(1280)), ("Mixed_7c", e(2048))]
    return convs + [(f"{blk}.{name}", i, o, k) for blk, branches in blocks for name, i, o, k in branches]


def torchvision_inception_v3_state_dict(seed: int, num_classes: int = 1000) -> Dict[str, torch.Tensor]:
    """A state_dict in the layout of torchvision's `inception_v3` (the public
    ImageNet checkpoints': `<module>.conv.weight` OIHW, `<module>.bn.*` with
    `num_batches_tracked`, `AuxLogits.*`, `fc.*`), float32 torch tensors
    drawn from `np.random.default_rng(seed)`: conv weights He-scaled
    N(0, 2 / fan_in), BN scales U(0.5, 1.5), biases N(0, 0.1), running means
    N(0, 0.5) and variances U(0.5, 1.5) (a mean/variance swap shows), fc
    weights N(0, 1 / fan_in)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, value):
        sd[name] = torch.from_numpy(np.asarray(value, np.float32))

    for name, cin, cout, (kh, kw) in _torchvision_inception_v3_convs():
        put(f"{name}.conv.weight", rng.normal(0.0, np.sqrt(2.0 / (cin * kh * kw)), (cout, cin, kh, kw)))
        put(f"{name}.bn.weight", rng.uniform(0.5, 1.5, cout))
        put(f"{name}.bn.bias", rng.normal(0.0, 0.1, cout))
        put(f"{name}.bn.running_mean", rng.normal(0.0, 0.5, cout))
        put(f"{name}.bn.running_var", rng.uniform(0.5, 1.5, cout))
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    for prefix, cin in (("AuxLogits.fc", 768), ("fc", 2048)):
        put(f"{prefix}.weight", rng.normal(0.0, np.sqrt(1.0 / cin), (num_classes, cin)))
        put(f"{prefix}.bias", rng.normal(0.0, 0.1, num_classes))
    return sd
