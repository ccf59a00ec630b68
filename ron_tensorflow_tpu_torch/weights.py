"""Carry flax RON, SSD and zoo weights into the port's modules, and name the
port's tensors by their flax paths.

The JAX package names every variable by its flax path, joined with '/'
(`ron_tensorflow_tpu/train/checkpoint.py::flatten_params`), e.g.
`backbone/conv1_1/conv/kernel` or `block4_box/conv/bn/mean`. The port's
modules use the same path with '.', and torch's leaf names:

  conv  kernel [kh, kw, in, out] (HWIO)   -> weight [out, in, kh, kw] (OIHW);
        a depthwise kernel [kh, kw, 1, C] -> [C, 1, kh, kw] (groups=C)
  dense kernel [in, out]                  -> weight [out, in]
  2x2 deconv deconv_kernel [2, 2, in, out] -> weight [in, out, 2, 2], taps
        flipped (`layers.py:180-189`): weight[c, o, dy, dx] = kernel[1-dy, 1-dx, c, o]
  BN    scale / bias / mean / var          -> weight / bias / running_mean / running_var
  conv  bias, deconv_bias                  -> bias
  L2 normalization gamma                   -> gamma
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch


def _convert(path: str, value: torch.Tensor) -> Tuple[str, torch.Tensor]:
    *scope, leaf = path.split("/")
    if leaf == "kernel" and value.dim() == 2:  # Dense [in, out]
        return ".".join(scope + ["weight"]), value.t().contiguous()
    if leaf == "kernel":
        return ".".join(scope + ["weight"]), value.permute(3, 2, 0, 1).contiguous()
    if leaf == "deconv_kernel":
        return ".".join(scope + ["weight"]), value.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    renamed = {
        "scale": "weight",
        "bias": "bias",
        "deconv_bias": "bias",
        "mean": "running_mean",
        "var": "running_var",
        "gamma": "gamma",
    }
    if leaf not in renamed:
        raise KeyError(f"no torch counterpart for flax variable {path!r}")
    return ".".join(scope + [renamed[leaf]]), value.contiguous()


def from_jax_params(
    params_flat: Mapping[str, object], stats_flat: Mapping[str, object]
) -> Dict[str, torch.Tensor]:
    """Flax flat-name params and batch stats (numpy arrays or tensors) ->
    a float32 `state_dict` for any of the port's models (RON, SSD, the
    zoo's classifiers)."""
    state = {}
    for path, value in list(params_flat.items()) + list(stats_flat.items()):
        if not torch.is_tensor(value):
            value = torch.from_numpy(np.array(value, dtype=np.float32))
        key, tensor = _convert(path, value.float())
        state[key] = tensor
    return state


def _bf16_bits_to_f32(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16).float()


def load_trained_fixture(path: str):
    """The step-20000 trained RON-320 packed in
    `tests/fixtures/e2e_parity_trained.npz`: bf16 bit patterns stored as
    uint16 under 'wp::<flax path>' (params) and 'ws::<flax path>' (batch
    stats). Returns (params_flat, stats_flat) as float32 tensors."""
    params, stats = {}, {}
    with np.load(path, allow_pickle=False) as fx:
        for key in fx.files:
            if key.startswith("wp::"):
                params[key[4:]] = _bf16_bits_to_f32(fx[key])
            elif key.startswith("ws::"):
                stats[key[4:]] = _bf16_bits_to_f32(fx[key])
    if not params:
        raise ValueError(f"{path} holds no packed 'wp::' weights")
    return params, stats


_TORCH_TO_FLAX_LEAF = {
    # module type name -> {torch leaf: flax leaf}
    "Conv2d": {"weight": "kernel", "bias": "bias"},
    "BareConv": {"weight": "kernel", "bias": "bias"},
    "Dense": {"weight": "kernel", "bias": "bias"},
    "ConvTranspose": {"weight": "deconv_kernel", "bias": "deconv_bias"},
    "BatchNorm": {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"},
    "L2Normalization": {"gamma": "gamma"},
}


def jax_names(model: torch.nn.Module) -> Dict[str, str]:
    """{torch name: flax path} of every parameter and buffer of `model`,
    the inverse of `from_jax_params`'s renaming. The leaf follows the module
    that owns the tensor: a conv's or a dense layer's `weight` is flax's
    `kernel`, the 2x2 deconv's `deconv_kernel`, a BatchNorm's `scale`. The
    port's `Conv` holds its nn.Conv2d as `.conv`, as flax does."""
    names = {}
    for name, _ in list(model.named_parameters()) + list(model.named_buffers()):
        scope, _, leaf = name.rpartition(".")
        owner = type(model.get_submodule(scope)).__name__
        if owner not in _TORCH_TO_FLAX_LEAF or leaf not in _TORCH_TO_FLAX_LEAF[owner]:
            raise KeyError(f"no flax counterpart for {name!r} ({owner})")
        names[name] = "/".join(scope.split(".") + [_TORCH_TO_FLAX_LEAF[owner][leaf]])
    return names


def to_jax_layout(path: str, value: torch.Tensor) -> np.ndarray:
    """A port tensor in its flax variable's layout (the inverse of `_convert`)."""
    value = value.detach().float().cpu()
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "kernel" and value.dim() == 2:
        value = value.t()
    elif leaf == "kernel":
        value = value.permute(2, 3, 1, 0)
    elif leaf == "deconv_kernel":
        value = value.permute(2, 3, 0, 1).flip(0, 1)
    return value.contiguous().numpy()


def to_jax_params(model: torch.nn.Module, tensors: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """(torch name, tensor) pairs of `model` (parameters, their gradients,
    buffers) -> {flax path: array in the flax layout}."""
    names = jax_names(model)
    return {names[n]: to_jax_layout(names[n], t) for n, t in tensors}
