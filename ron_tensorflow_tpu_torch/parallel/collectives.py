"""Collectives over a torch.distributed process group, autograd-aware.

The port has no GSPMD: where the JAX package lets XLA insert the
collectives of a sharded program, the port calls these. Every helper is
the identity when its group is None (a mesh axis of size 1), so that one
code path serves one process and many.

- `all_reduce_sum(x, group)`: y = sum over the group's ranks of x. Its
  backward is the same all-reduce of the output gradients: each rank's
  loss is its share of the global loss, so dL/dx_r = sum_r' dL_r'/dy.
- `reduce_grad(x, group)`: the identity forward, an all-reduce-sum of the
  gradient backward. A conv sharded on its output channels computes only
  its slice's share of its input's gradient; this sums the shares over the
  model group, so that every model rank holds the whole gradient upstream.
- `gather_channels(x, group)`: concatenates the ranks' channel slices
  (dim 1) in rank order. Its backward takes this rank's own slice of the
  output gradient: every model rank computes the same thing downstream, so
  the gradient of the gathered tensor is already whole on each rank.
  (`torch.distributed.nn.functional.all_gather` would sum it over the
  ranks, multiplying every gradient upstream by the model size.)
- `all_gather_rows(x, group)`: concatenates dim 0 in rank order, no
  gradient (SSD's hard-negative threshold, the evaluator's results).
- `broadcast_int`, `barrier`: host decisions that every rank must share.

Only all-reduce, all-gather and broadcast are used, the collectives gloo
runs on CUDA tensors as well as on CPU ones.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[1]
        return _all_gather(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.rank * ctx.width, ctx.width).contiguous(), None


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return _all_reduce(x, group)


def reduce_grad(x: torch.Tensor, group: Group) -> torch.Tensor:
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ReduceGrad.apply(x, group)


def gather_channels(x: torch.Tensor, group: Group) -> torch.Tensor:
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherChannels.apply(x, group)
    return _all_gather(x, group, 1)


def all_gather_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _all_gather(x, group, 0)


def scalar_device(group: Group = None) -> torch.device:
    """Where a group's host-decision scalars live: the current card under
    NCCL (it takes CUDA tensors only), else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_int(value: int, src: int = 0, group: Group = None) -> int:
    """`value` of global rank `src`, on every rank of `group` (the world by
    default); `value` itself when torch.distributed is not initialized."""
    if not dist.is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=scalar_device(group))
    dist.broadcast(t, src=src, group=group)
    return int(t.item())


def barrier(group: Group = None) -> None:
    """Every rank of `group` (the world by default) reaches this point
    before any leaves it: one all-reduce of a scalar."""
    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1, device=scalar_device(group)), group=group)
