"""The weights both sides are handed: read from a file of the checkout or
drawn from the seed on the device.

- `flax_npz_bf16`: bfloat16 bit patterns stored as uint16 under
  'wp::<flax path>' (parameters) and 'ws::<flax path>' (BatchNorm
  statistics), as the repository's trained RON-320 fixture holds them;
  renamed to the PyTorch modules' names and layouts here.
- `seeded`: flax's initializers (glorot-uniform kernels, zero biases,
  BatchNorm at scale 1, shift 0, statistics 0 and 1, an L2 normalization
  at its initial scale), drawn from one `torch.Generator` on the device in
  one call.

Both give float32 tensors on the device, keyed by the names of
`reference.nets`.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .reference.nets import param_spec

LEAVES = {"scale": "weight", "bias": "bias", "deconv_bias": "bias", "mean": "running_mean",
          "var": "running_var", "gamma": "gamma"}


def flax_to_torch(path: str, value: torch.Tensor):
    """A flax variable (path joined by '/') -> (PyTorch name, tensor in its layout)."""
    *scope, leaf = path.split("/")
    if leaf == "kernel":  # [kh, kw, in, out] -> [out, in, kh, kw]
        return ".".join(scope + ["weight"]), value.permute(3, 2, 0, 1).contiguous()
    if leaf == "deconv_kernel":  # flax stores the transposed conv's taps flipped
        return ".".join(scope + ["weight"]), value.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    return ".".join(scope + [LEAVES[leaf]]), value


def flax_npz_bf16(path: str, device) -> Dict[str, torch.Tensor]:
    out = {}
    with np.load(path, allow_pickle=False) as fx:
        for key in fx.files:
            if key.startswith(("wp::", "ws::")):
                bits = torch.from_numpy(np.ascontiguousarray(fx[key]).view(np.int16)).to(device)
                name, t = flax_to_torch(key[4:], bits.view(torch.bfloat16).float())
                out[name] = t
    return out


def _init(shape, kind: str, u: torch.Tensor) -> torch.Tensor:
    """One tensor of flax's initializer from uniforms u in [0, 1)."""
    if kind in ("kernel", "deconv_kernel"):
        if kind == "kernel":
            out_c, in_c, kh, kw = shape
        else:
            in_c, out_c, kh, kw = shape
        limit = math.sqrt(6.0 / (kh * kw * in_c + kh * kw * out_c))
        return (u * 2.0 - 1.0).mul_(limit).reshape(shape)
    if kind in ("bn_scale", "bn_var"):
        return torch.ones(shape, device=u.device)
    if kind.startswith("gamma:"):
        return torch.full(shape, float(kind.split(":")[1]), device=u.device)
    return torch.zeros(shape, device=u.device)


def seeded(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = param_spec(cfg)
    sizes = [math.prod(shape) if kind.endswith("kernel") else 0 for shape, kind in spec.values()]
    g = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, (shape, kind)), n in zip(spec.items(), sizes):
        out[name] = _init(shape, kind, draw[at:at + n])
        at += n
    return out


def load(cfg: dict, seed: int, device, root=".") -> Dict[str, torch.Tensor]:
    """The configuration's weights (`cfg["weights"]`; a file relative to the checkout's root) on `device`."""
    w = cfg["weights"]
    if w["kind"] == "flax_npz_bf16":
        return flax_npz_bf16(str(Path(root) / w["file"]), device)
    if w["kind"] == "seeded":
        return seeded(cfg, seed, device)
    raise ValueError(f"unknown weights kind {w['kind']!r}")
