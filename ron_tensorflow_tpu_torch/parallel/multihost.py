"""Multi-process runs: process-group init, per-process input shards, and
the placement of batches and states onto the mesh.

Port of `ron_tensorflow_tpu/parallel/multihost.py`. Every process runs the
same program on its own device; torch.distributed collectives keep them in
step (the reference's parameter servers have no counterpart, as in the JAX
package). Recovery is checkpoint-based: a failed rank fails the run, and
the restarted run resumes from the newest checkpoint.

A "global" batch in torch is each rank's local rows plus their place in
the global batch: `host_local_to_global` returns a `GlobalBatch`, a dict of
device tensors that carries the global row offset and the global batch
size. Draws of the global batch (augmentation, loss negatives, dropout)
are made whole on every rank from the step's generator and cut to the
rank's rows (`take_rows`), so that N ranks train on exactly what one
process trains on.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .collectives import all_reduce_sum
from .mesh import Mesh, local_slice

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Initialize torch.distributed; returns whether it did.

    With `coordinator_address` ('host:port'), `num_processes` and
    `process_id`: `tcp://`. Without: the `env://` variables that
    `python -m torch.distributed.run` sets (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE), if WORLD_SIZE is set. Nothing when `num_processes` is 1 or
    no launcher set WORLD_SIZE (one process), or when already initialized.

    backend: "nccl" for a CUDA device, "gloo" for the CPU, unless named
    (two ranks on one card need gloo: NCCL takes one rank per device).
    Nothing falls back from one to the other. `timeout` bounds the init and
    every collective (gloo's, and NCCL's through its watchdog)."""
    if dist.is_initialized() or num_processes == 1:
        return False
    if coordinator_address is None and "WORLD_SIZE" not in os.environ:
        return False
    if coordinator_address is not None and (num_processes is None or process_id is None):
        raise ValueError("a coordinator address needs num_processes and process_id")
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                                rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    return True


def process_info() -> Tuple[int, int]:
    """(rank, world size): the worker_index / num_workers of input sharding."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_device(device="cuda") -> torch.device:
    """The device of this process: `cuda:LOCAL_RANK` for a bare "cuda"
    under a launcher that sets LOCAL_RANK, else `device` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


class GlobalBatch(dict):
    """A rank's rows of a global batch: device tensors, plus `offset` (the
    global index of the first row) and `global_size` (rows in all)."""

    def __init__(self, tensors: Dict[str, torch.Tensor], offset: int, global_size: int):
        super().__init__(tensors)
        self.offset = offset
        self.global_size = global_size


def batch_rows(batch: Dict) -> Tuple[int, int, int]:
    """(offset, rows here, global rows) of a batch: a `GlobalBatch`'s, or
    (0, B, B) for a whole one."""
    b = next(iter(batch.values())).shape[0]
    if isinstance(batch, GlobalBatch):
        return batch.offset, b, batch.global_size
    return 0, b, b


def host_local_to_global(batch: Dict, mesh: Mesh, device="cpu", non_blocking: bool = False) -> GlobalBatch:
    """This rank's local batch on its device, as rows
    [data_index * B, (data_index + 1) * B) of a global batch of
    data_size * B rows (`data.batch_size` is the local batch)."""
    tensors = {k: torch.as_tensor(v).to(device, non_blocking=non_blocking) for k, v in batch.items()}
    b = next(iter(tensors.values())).shape[0]
    return GlobalBatch(tensors, mesh.data_index * b, mesh.data_size * b)


def with_rows(batch: Dict, like: Dict) -> Dict:
    """`batch` with the global rows of `like` (a `GlobalBatch`), if any."""
    if isinstance(like, GlobalBatch):
        return GlobalBatch(batch, like.offset, like.global_size)
    return batch


def take_rows(draws, offset: int, count: int, dim: int = 0):
    """Rows [offset, offset + count) along `dim` of every tensor of a draws
    structure (tensors, nested tuples and named tuples, None)."""
    if draws is None:
        return None
    if isinstance(draws, tuple):
        return type(draws)(*(take_rows(d, offset, count, dim) for d in draws))
    return draws.narrow(dim, offset, count)


@torch.no_grad()
def host_tree_to_global(state: Dict[str, torch.Tensor], mesh: Mesh, sharded: Dict[str, bool]) -> Dict[str, torch.Tensor]:
    """Rank 0's whole tensors on every rank (broadcast), then each rank's
    `model` slice of the sharded ones: the placement of an initialized or
    restored state onto a multi-process mesh."""
    out = {}
    for k, t in state.items():
        t = t.contiguous()
        if dist.is_initialized():
            dist.broadcast(t, src=0)
        out[k] = local_slice(t, mesh).clone() if sharded.get(k) else t
    return out


def sum_over(values: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each 0-dim tensor summed over `group`, with one all-reduce."""
    if group is None or not values:
        return values
    keys = list(values)
    total = all_reduce_sum(torch.stack([values[k].detach() for k in keys]), group)
    return dict(zip(keys, total.unbind()))
