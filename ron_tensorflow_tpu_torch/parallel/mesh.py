"""The (data, model) mesh over torch.distributed ranks, and the sharding rules.

Port of `ron_tensorflow_tpu/parallel/mesh.py`. Axes:
- 'data': the batch. Each data rank holds its rows of the global batch;
  BatchNorm statistics, loss denominators and gradients are summed over
  the data group, so that the step is the one-process step on the global
  batch (the JAX package gets this from GSPMD).
- 'model': tensor parallelism over the output channels of the widest
  layers (fc6/fc7, the inception class convs, the objectness and box
  convs): each model rank holds its channel slice of the kernel, bias and
  BatchNorm, and gathers the channels after the layer's epilogue.

Ranks fill the grid row-major, as `make_mesh` reshapes JAX's device list:
rank r sits at (r // model, r % model). Its data group is the ranks of its
column (the same model index), its model group those of its row. An axis
of size 1 has no group (None), and the collectives are then the identity.

The rules are JAX's regexes verbatim (`mesh.py:51-76`), matched on each
tensor's flax path (`weights.jax_names`). A partition spec is given in the
flax layout (a conv kernel [kh, kw, in, out] shards its last axis); the
port's tensors are OIHW, so every sharded tensor of the port splits its
dim 0 (`TORCH_SHARD_DIM`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..weights import jax_names
from .collectives import Group

# (regex on '/'-joined param path) -> PartitionSpec for the kernel.
# Conv kernels are [kh, kw, in, out]; we shard the out channel on 'model'.
_TP_KERNEL_PATTERNS = (
    r".*backbone/fc6/conv/kernel",
    r".*backbone/fc7/conv/kernel",
    r".*_cls/inception\d_(3x3|1x1)/conv/kernel",
    r".*_objectness/conv/conv/kernel",
    r".*_box/conv/conv/kernel",
)
_TP_BIAS_PATTERNS = tuple(p.replace("kernel", "bias") for p in _TP_KERNEL_PATTERNS)
# BN of a TP-sharded conv is per-output-channel -> its affine params and
# running stats shard on 'model' too.
_TP_BN_PARAM_PATTERNS = tuple(
    p.replace("conv/kernel", "bn/(scale|bias)") for p in _TP_KERNEL_PATTERNS
)
_TP_BN_STATS_PATTERNS = tuple(
    p.replace("conv/kernel", "bn/(mean|var)") for p in _TP_KERNEL_PATTERNS
)
KERNEL_SPEC = (None, None, None, "model")
VECTOR_SPEC = ("model",)
TORCH_SHARD_DIM = 0  # OIHW out channels, and every per-channel vector


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, model) grid of the world's ranks."""

    shape: Tuple[int, int]
    rank: int
    data_group: Group = None  # the ranks of this rank's column; None at data size 1
    model_group: Group = None  # the ranks of this rank's row; None at model size 1

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def model_size(self) -> int:
        return self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[1]


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The (data, model) mesh over every rank: (world, 1) by default (pure
    data parallelism, as JAX's default). Every rank must call it, in the
    same order as every other group it makes (torch's `new_group` is
    collective)."""
    n = world_size()
    if shape is None:
        shape = (n, 1)
    shape = tuple(int(s) for s in shape)
    need = shape[0] * shape[1]
    if need > n:
        raise ValueError(f"mesh shape {shape} needs {need} devices, have {n}")
    if need < n:
        raise ValueError(f"mesh shape {shape} leaves {n - need} of the {n} ranks out: every rank must be in the mesh")
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = Mesh(shape, rank)
    d, m = shape
    if d > 1:  # one group per column; new_group is collective, so every rank makes all of them
        for col in range(m):
            g = dist.new_group([r * m + col for r in range(d)])
            if col == mesh.model_index:
                mesh.data_group = g
    if m > 1:
        for row in range(d):
            g = dist.new_group([row * m + c for c in range(m)])
            if row == mesh.data_index:
                mesh.model_group = g
    return mesh


def partition_rules():
    """(pattern, spec) rules for model-parallel parameters, JAX's."""
    rules = [(re.compile(p), KERNEL_SPEC) for p in _TP_KERNEL_PATTERNS]
    rules += [(re.compile(p), VECTOR_SPEC) for p in _TP_BIAS_PATTERNS]
    rules += [(re.compile(p), VECTOR_SPEC) for p in _TP_BN_PARAM_PATTERNS]
    return rules


def _specs(model: torch.nn.Module, tensors, rules, mesh: Mesh) -> Dict[str, Optional[tuple]]:
    names = jax_names(model)
    use_tp = mesh.model_size > 1
    out = {}
    for name, t in tensors:
        spec = None
        if use_tp:
            for pat, s in rules:
                if pat.fullmatch(names[name]) and len(s) <= t.dim():
                    spec = s
                    break
        out[name] = spec
    return out


def partition_params(model: torch.nn.Module, mesh: Mesh) -> Dict[str, Optional[tuple]]:
    """{parameter name: partition spec in the flax layout, or None where
    replicated}, JAX `partition_params`' rules on the flax names."""
    return _specs(model, model.named_parameters(), partition_rules(), mesh)


def partition_batch_stats(model: torch.nn.Module, mesh: Mesh) -> Dict[str, Optional[tuple]]:
    """{buffer name: spec or None}: 'model'-sharded for the BatchNorms that
    follow a TP-sharded conv."""
    rules = [(re.compile(p), VECTOR_SPEC) for p in _TP_BN_STATS_PATTERNS]
    return _specs(model, model.named_buffers(), rules, mesh)


def partition_opt_state(opt_state: Dict, model: torch.nn.Module, mesh: Mesh) -> Dict:
    """An optimizer state's specs: each per-parameter tensor list follows
    the parameters' specs; the step count is replicated."""
    specs = list(partition_params(model, mesh).values())
    return {k: list(specs) if isinstance(v, list) else None for k, v in opt_state.items()}


def partition_batch(batch: Dict, mesh: Mesh) -> Dict[str, tuple]:
    """Every batch tensor shards its leading (batch) dim over 'data'."""
    return {k: ("data",) + (None,) * (v.dim() - 1) for k, v in batch.items()}


def sharded_names(model: torch.nn.Module, mesh: Mesh) -> Dict[str, bool]:
    """{parameter or buffer name: split over the model group?}."""
    specs = {**partition_params(model, mesh), **partition_batch_stats(model, mesh)}
    return {k: v is not None for k, v in specs.items()}


def local_slice(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of a whole sharded tensor (dim 0)."""
    n = t.shape[TORCH_SHARD_DIM]
    if n % mesh.model_size:
        raise ValueError(f"{n} channels do not split over a model axis of {mesh.model_size}")
    w = n // mesh.model_size
    return t.narrow(TORCH_SHARD_DIM, mesh.model_index * w, w)
