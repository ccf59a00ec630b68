"""The benchmark's side of the program under test: building the port's
model from a configuration file and the benchmark's weights, and the
`Recorder` that stands in the place of the model inside a detection head.

The port is imported inside these functions, never when the module is
imported, so that the reference and the tests import `ronbench` without it.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(cfg: dict, weights: dict, device: torch.device, fuse_block1: bool):
    """(the port's model for `cfg["network"]` in `cfg["dtype"]`, holding
    `weights`, on `device`; its spec). K-B (the fused block-1 kernel) where
    asked for, on a card, at a shape the kernel takes, as the port's CLI
    decides for batched inference."""
    from ron_tensorflow_tpu_torch.kernels import fused_block1_supported
    from ron_tensorflow_tpu_torch.models import get_network

    fuse = fuse_block1 and device.type == "cuda" and fused_block1_supported(*cfg["img_shape"])
    with torch.device(device):  # built where it runs; every tensor is then overwritten from `weights`
        model, spec = get_network(cfg["network"], dtype=DTYPES[cfg["dtype"]], fuse_block1=fuse)
    model.load_state_dict(weights, strict=True)
    return model, spec


class Recorder:
    """In the place of a head's model: calls it, marks the span points
    around it when `spans` is set, and keeps its outputs when `keep` is."""

    def __init__(self, model):
        self.model = model
        self.spans = None
        self.keep = False
        self.kept = None

    def __call__(self, images, *args, **kwargs):
        if self.spans is not None:
            self.spans.mark("model_start")
        out = self.model(images, *args, **kwargs)
        if self.spans is not None:
            self.spans.mark("model_end")
        if self.keep:
            self.kept = out
        return out


def heads_of(out) -> dict:
    """A head's model outputs (a named tuple or a dict) as a dict."""
    return out._asdict() if hasattr(out, "_asdict") else dict(out)


def sample_pass(seed: int, passes: int) -> int:
    """The pass over the pool whose calls are compared, drawn from the seed."""
    return int(np.random.default_rng([seed, 1]).integers(0, passes))


@contextlib.contextmanager
def full_f32():
    """float32 matrix products and convolutions without TF32, restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def marker(profiling: bool):
    """`torch.profiler.record_function` while profiling, else a no-op."""
    if profiling:
        return torch.profiler.record_function
    return lambda name: contextlib.nullcontext()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stages:
    """Seconds of each stage of a set-up, printed on standard error."""

    def __init__(self):
        self.t, self.parts = time.perf_counter(), []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.t:.3f}")
        self.t = now

    def report(self, cell: str) -> None:
        print(f"ronbench: {cell} set-up stages (s): " + ", ".join(self.parts), file=sys.stderr)
