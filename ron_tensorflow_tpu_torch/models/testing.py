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


def seeded_flax_params(model: torch.nn.Module, seed: int, gain: float = 1.0
                       ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(params, batch stats) of `model` as float32 numpy arrays in the flax
    layout, keyed by flax path, drawn from `np.random.default_rng(seed)`:
    conv and deconv kernels N(0, gain^2 / fan_in) (fan_in = kh * kw * in;
    gain 1 keeps a linear layer's output at its input's scale, sqrt(2) a
    ReLU layer's), biases N(0, 0.1), BatchNorm scales U(0.5, 1.5), L2
    normalization scales U(10, 30), BatchNorm means N(0, 0.1) and variances
    U(0.5, 1.5)."""
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
        else:  # biases, BN means
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
