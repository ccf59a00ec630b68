"""Training state, the train step and the eval step.

Port of `ron_tensorflow_tpu/train/state.py`. One train step holds the whole
per-step computation, in the JAX step's order (state.py:83-146): gt
encoding -> forward in train mode (BatchNorm on batch statistics, its
running statistics updated) -> loss -> backward -> optimizer update -> EMA
-> `metrics["grad_norm"]`, the global gradient norm before clipping.

Where JAX returns a new state, the port updates the model's parameters,
buffers and the optimizer's state in place: `TrainState.params` and
`batch_stats` are the model's own tensors.

An f32 model runs its forward AND backward inside `full_f32_convs()`: the
backward's convolutions run when `backward()` is called, outside
`RON.forward`'s own block, and would otherwise take the caller's cuDNN TF32
flag (True by default). A bf16 model is left alone.

Over a mesh (`make_train_step(..., mesh=...)`, the model distributed by
`models.shard_model`): the batch is a rank's rows of the global batch
(`parallel.GlobalBatch`); the loss is the rank's share of the global
batch's (`losses.ron`, `losses.ssd`); the flat gradient is summed over the
data group in one all-reduce; the replicated tensors' gradients are model
rank 0's on every model rank (one broadcast over the model group: two
ranks' identical computations may differ in the last bits, and the
replicas would drift), and so are the metrics; `global_norm` adds the
squares of the
'model'-sharded tensors over the model group, for clipping and for
`grad_norm`; the loss parts are summed over the data group, so every
metric is global and equal on every rank. Momentum and EMA stay sharded
like their parameters (they are built from the sharded tensors).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from .. import full_f32_convs
from ..losses.ron import RonLossConfig, ron_losses
from ..losses.ssd import SsdLossConfig, ssd_losses
from ..models.layers import init_like_flax_
from ..models.ssd import SSD
from ..ops.encode import TargetEncoder
from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import Mesh, sharded_names
from ..parallel.multihost import batch_rows, host_tree_to_global, sum_over
from ..utils.profiling import span
from .optimizer import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    """Step, parameters, BatchNorm buffers, optimizer state and the optional
    EMA shadow of the parameters (ref: eval_ssd_network.py:209-217)."""

    step: int
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: Dict
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    def state_dict(self) -> Dict:
        """Everything, on the CPU: what a checkpoint holds."""
        cpu = lambda d: None if d is None else {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
        opt = {k: [t.detach().cpu() for t in v] if isinstance(v, list) else v for k, v in self.opt_state.items()}
        return {"step": self.step, "params": cpu(self.params), "batch_stats": cpu(self.batch_stats),
                "opt_state": opt, "ema_params": cpu(self.ema_params)}

    @torch.no_grad()
    def load_state_dict(self, saved: Dict) -> None:
        """Copy a `state_dict()` into this state's tensors (in place, so the
        model keeps sharing them)."""
        for mine, theirs in ((self.params, saved["params"]), (self.batch_stats, saved["batch_stats"]),
                             (self.ema_params, saved["ema_params"])):
            if (mine is None) != (theirs is None) or (mine is not None and mine.keys() != theirs.keys()):
                raise KeyError("checkpoint does not match the train state's tensors")
            for k, t in (mine or {}).items():
                t.copy_(theirs[k])
        if self.opt_state.keys() != saved["opt_state"].keys():
            raise KeyError("checkpoint was written by another optimizer")
        for k, v in saved["opt_state"].items():
            if isinstance(v, list):
                for t, s in zip(self.opt_state[k], v, strict=True):
                    t.copy_(s)
            else:
                self.opt_state[k] = v
        self.step = int(saved["step"])


def _state_tensors(saved: Dict) -> Dict[str, tuple]:
    """{key: (tensor name, tensor)} over a `state_dict()`'s tensors; the
    optimizer's per-parameter lists are named by the parameters."""
    names = list(saved["params"])
    out = {}
    for part in ("params", "batch_stats", "ema_params"):
        for k, t in (saved[part] or {}).items():
            out[f"{part}:{k}"] = (k, t)
    for key, v in saved["opt_state"].items():
        if isinstance(v, list):
            for k, t in zip(names, v, strict=True):
                out[f"opt_state/{key}:{k}"] = (k, t)
    return out


def _with_tensors(saved: Dict, tensors: Dict[str, torch.Tensor]) -> Dict:
    """`saved` with its tensors replaced by `tensors` (keyed as `_state_tensors`)."""
    out = {"step": saved["step"], "opt_state": {}}
    for part in ("params", "batch_stats", "ema_params"):
        out[part] = None if saved[part] is None else {k: tensors[f"{part}:{k}"] for k in saved[part]}
    for key, v in saved["opt_state"].items():
        out["opt_state"][key] = ([tensors[f"opt_state/{key}:{k}"] for k in saved["params"]]
                                 if isinstance(v, list) else v)
    return out


def shard_state_dict(saved: Dict, mesh: Mesh, sharded: Dict[str, bool], device) -> Dict:
    """A whole `state_dict()` onto the mesh: rank 0's tensors on every rank,
    on `device`, and each rank's 'model' slice of the sharded ones
    (`parallel.host_tree_to_global`)."""
    named = _state_tensors(saved)
    placed = host_tree_to_global({key: t.to(device) for key, (_, t) in named.items()}, mesh,
                                 {key: sharded.get(name, False) for key, (name, _) in named.items()})
    return _with_tensors(saved, placed)


def gathered_state_dict(state: "TrainState", mesh: Mesh, sharded: Dict[str, bool]) -> Dict:
    """The whole `state_dict()` of a sharded state, on the CPU in the
    one-process layout: the 'model' slices gathered over the model group in
    rank order (every rank of the group takes part)."""
    if mesh.model_group is None:
        return state.state_dict()
    live = {"step": state.step, "params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "ema_params": state.ema_params}
    whole = {key: (all_gather_rows(t, mesh.model_group) if sharded.get(name, False) else t).detach().cpu()
             for key, (name, t) in _state_tensors(live).items()}
    return _with_tensors(live, whole)


def create_train_state(model: torch.nn.Module, tx: Optimizer, generator: Optional[torch.Generator] = None,
                       ema: bool = False) -> TrainState:
    """The state of `model` as it stands, or, with `generator`, after
    re-initializing its parameters as flax does (`layers.init_like_flax_`)."""
    if generator is not None:
        init_like_flax_(model, generator)
    params = dict(model.named_parameters())
    return TrainState(
        step=0,
        params=params,
        batch_stats=dict(model.named_buffers()),
        opt_state=tx.init(list(params.values())),
        ema_params={k: v.detach().clone() for k, v in params.items()} if ema else None,
    )


def detection_loss_fn(loss_config, group=None) -> Callable:
    """(outputs, targets, generator, draws, rows) -> (loss, metrics) for the
    config's family (`state.py:53-79`): `SsdLossConfig` -> `ssd_losses`,
    which draws nothing; otherwise (`RonLossConfig`) `ron_losses`, whose
    negatives come from `draws` or `generator`. `group` (a data group) and
    `rows` (offset, global batch) make it the rank's share of the global
    batch's loss."""
    if isinstance(loss_config, SsdLossConfig):
        def ssd_fn(out, targets, generator=None, draws=None, rows=None):
            return ssd_losses(out.logits, out.locations, targets.labels, targets.locations, targets.scores,
                              loss_config, group=group)

        return ssd_fn

    def fn(out, targets, generator=None, draws=None, rows=None):
        return ron_losses(out.logits, out.locations, out.objness_logits, out.objness_pred,
                          targets.labels, targets.locations, loss_config, generator=generator, draws=draws,
                          group=group, rows=rows)

    return fn


def train_forward(model, images, generator: Optional[torch.Generator] = None, rows=None):
    """The model in train mode. Only SSD draws in its forward (its dropout
    masks, from `generator`, for the global batch when `rows` is given)."""
    if isinstance(model, SSD):
        return model(images, train=True, generator=generator, rows=rows)
    return model(images, train=True)


def _flat(tensors, collective) -> list:
    """`collective` run once on the tensors' concatenation; views of the
    result, in their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_reduce_flat(tensors, group) -> list:
    """The tensors summed over `group` with one all-reduce."""
    return _flat(tensors, lambda flat: dist.all_reduce(flat, group=group))


def pinned_precision(model) -> contextlib.AbstractContextManager:
    """Full-f32 cuDNN convolutions for an f32 model, nothing for bf16."""
    return full_f32_convs() if getattr(model, "dtype", torch.float32) == torch.float32 else contextlib.nullcontext()


def make_train_step(model, encoder: TargetEncoder, tx: Optimizer, loss_config=RonLossConfig(),
                    ema_decay: Optional[float] = None, mesh: Optional[Mesh] = None) -> Callable:
    """The train step: (state, batch, generator=None, draws=None) ->
    (state, metrics), batch = dict(image [B, H, W, 3] whitened, gt_labels
    [B, G], gt_boxes [B, G, 4], gt_valid [B, G]) on the model's device.
    The forward's draws (SSD's dropout masks) come from `generator`; RON's
    loss samples its negatives with `draws` ([2, B, N] uniforms) or, if none
    are given, with `generator` after the forward. Metrics are 0-dim tensors
    on the device (reading one waits for the step).

    mesh: the model's mesh (see the module's docstring); the batch is then
    a `GlobalBatch` (or the whole global batch), and `draws` the global
    batch's.

    Its stages run inside the tracer's spans (`utils/profiling.py`):
    `train.encode`, `train.forward_loss`, `train.backward`, `train.update`
    (the reductions, the optimizer and the EMA)."""
    data_group = mesh.data_group if mesh is not None else None
    model_group = mesh.model_group if mesh is not None else None
    sharded = sharded_names(model, mesh) if mesh is not None else {}
    src = mesh.data_index * mesh.model_size if mesh is not None else 0  # model rank 0 of this rank's row
    loss = detection_loss_fn(loss_config, data_group)

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None, draws=None):
        offset, _, total_rows = batch_rows(batch)
        rows = None if mesh is None else (offset, total_rows)
        device = batch["image"].device
        with span("train.encode", device):
            targets = encoder.batched(batch["gt_labels"], batch["gt_boxes"], batch["gt_valid"])
        params = list(state.params.values())
        for p in params:
            p.grad = None
        with pinned_precision(model):
            with span("train.forward_loss", device):
                out = train_forward(model, batch["image"], generator, rows)
                total, metrics = loss(out, targets, generator, draws, rows)
            with span("train.backward", device):
                total.backward()
        with span("train.update", device):
            state, metrics = update(state, params, metrics)
        return state, metrics

    def update(state: TrainState, params: list, metrics: Dict):
        """The gradients reduced over the mesh, the metrics, the optimizer's
        step and the EMA."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if data_group is not None:
            grads = all_reduce_flat(grads, data_group)
        if model_group is not None:
            # the replicated tensors' gradients: model rank 0's on every model rank (one broadcast), so the
            # replicas cannot drift where two ranks' identical computations differ in the last bits
            # (cuDNN's non-deterministic backward on the card; on the CPU, seen in the forward's loss)
            rep = [i for i, k in enumerate(state.params) if not sharded.get(k, False)]
            for i, g in zip(rep, _flat([grads[i] for i in rep],
                                       lambda flat: dist.broadcast(flat, src, group=model_group))):
                grads[i] = g
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(sum_over({k: v for k, v in metrics.items() if k.startswith("loss/")}, data_group))
        if model_group is not None:  # model rank 0's metrics on every model rank, as with its gradients
            keys = list(metrics)
            flat = torch.stack([metrics[k].to(torch.float64) for k in keys])
            dist.broadcast(flat, src, group=model_group)
            metrics = {k: v.to(metrics[k].dtype) for k, v in zip(keys, flat.unbind())}
        metrics["grad_norm"] = global_norm(grads, [sharded.get(k, False) for k in state.params], model_group)
        tx.step(params, grads, state.opt_state, norm=metrics["grad_norm"])
        for p in params:
            p.grad = None
        if ema_decay is not None and state.ema_params is not None:
            with torch.no_grad():
                for e, p in zip(state.ema_params.values(), params):
                    e.mul_(ema_decay).add_((1.0 - ema_decay) * p)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model, encoder: TargetEncoder, loss_config=RonLossConfig()) -> Callable:
    """Forward (inference BatchNorm) + loss, no update (ref:
    eval_ron_network.py:212-220): (state, batch, generator=None, draws=None)
    -> (outputs, metrics)."""
    loss = detection_loss_fn(loss_config)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None, draws=None):
        targets = encoder.batched(batch["gt_labels"], batch["gt_boxes"], batch["gt_valid"])
        out = model(batch["image"], train=False)
        _, metrics = loss(out, targets, generator, draws)
        return out, metrics

    return eval_step
