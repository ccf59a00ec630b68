"""The CLI's `--debug-nans`: stop at the first NaN a model computes, naming
the module that computed it.

The counterpart of `jax_debug_nans`, which the JAX CLI turns on for the same
flag (ref: ron_net.py:399-402, tfdbg's has_inf_or_nan filter): NaN only,
as JAX's flag, not infinities. `nan_hooks(model)` adds a forward hook to
every module of `model` that raises `FloatingPointError` when a floating
output of the module holds a NaN; the innermost module returns first, so
the error names where the NaN appeared. Each hook reads its outputs back,
which waits for the device at every module: a debugging aid, slow on the
card. The CLI turns on `torch.autograd.set_detect_anomaly` beside the
hooks, for NaNs that appear in the backward pass.
"""

from __future__ import annotations

from typing import List

import torch


def has_nan(value) -> bool:
    """Whether a tensor, or any tensor inside tuples, lists and dicts, holds a NaN."""
    if torch.is_tensor(value):
        return value.is_floating_point() and bool(torch.isnan(value).any())
    if isinstance(value, (tuple, list)):
        return any(has_nan(v) for v in value)
    if isinstance(value, dict):
        return any(has_nan(v) for v in value.values())
    return False


def nan_hooks(model: torch.nn.Module) -> List[torch.utils.hooks.RemovableHandle]:
    """A NaN check on the outputs of every module of `model`; returns the
    hooks' handles."""
    handles = []
    for name, module in model.named_modules():
        label = name or type(model).__name__

        def hook(mod, inputs, output, label=label):
            if has_nan(output):
                raise FloatingPointError(f"NaN in the output of module {label!r} ({type(mod).__name__})")

        handles.append(module.register_forward_hook(hook))
    return handles
