"""PyTorch/CUDA port of `ron_tensorflow_tpu`.

The layout mirrors the JAX package (`models/`, `ops/`, `kernels/`,
`inference/`, `data/`), which stays as the reference the port is tested
against. This package imports torch and numpy only, never JAX or the JAX
package. Entry points take an explicit `device` that defaults to "cuda"
and raise when no card is present; tests pass `device="cpu"`.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Asking for CUDA on a machine
    without a card raises instead of carrying on silently on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


@contextlib.contextmanager
def full_f32_convs():
    """cuDNN convolutions in full f32 inside the block, whatever the
    caller's `torch.backends.cudnn.allow_tf32` (True by default, which
    runs f32 convolutions in TF32). The flag is restored on exit."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
