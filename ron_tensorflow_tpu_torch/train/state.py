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
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch

from .. import full_f32_convs
from ..losses.ron import RonLossConfig, ron_losses
from ..losses.ssd import SsdLossConfig, ssd_losses
from ..models.layers import init_like_flax_
from ..models.ssd import SSD
from ..ops.encode import TargetEncoder
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


def detection_loss_fn(loss_config) -> Callable:
    """(outputs, targets, generator, draws) -> (loss, metrics) for the
    config's family (`state.py:53-79`): `SsdLossConfig` -> `ssd_losses`,
    which draws nothing; otherwise (`RonLossConfig`) `ron_losses`, whose
    negatives come from `draws` or `generator`."""
    if isinstance(loss_config, SsdLossConfig):
        def ssd_fn(out, targets, generator=None, draws=None):
            return ssd_losses(out.logits, out.locations, targets.labels, targets.locations, targets.scores,
                              loss_config)

        return ssd_fn

    def fn(out, targets, generator=None, draws=None):
        return ron_losses(out.logits, out.locations, out.objness_logits, out.objness_pred,
                          targets.labels, targets.locations, loss_config, generator=generator, draws=draws)

    return fn


def train_forward(model, images, generator: Optional[torch.Generator] = None):
    """The model in train mode. Only SSD draws in its forward (its dropout
    masks, from `generator`)."""
    if isinstance(model, SSD):
        return model(images, train=True, generator=generator)
    return model(images, train=True)


def pinned_precision(model) -> contextlib.AbstractContextManager:
    """Full-f32 cuDNN convolutions for an f32 model, nothing for bf16."""
    return full_f32_convs() if getattr(model, "dtype", torch.float32) == torch.float32 else contextlib.nullcontext()


def make_train_step(model, encoder: TargetEncoder, tx: Optimizer, loss_config=RonLossConfig(),
                    ema_decay: Optional[float] = None) -> Callable:
    """The train step: (state, batch, generator=None, draws=None) ->
    (state, metrics), batch = dict(image [B, H, W, 3] whitened, gt_labels
    [B, G], gt_boxes [B, G, 4], gt_valid [B, G]) on the model's device.
    The forward's draws (SSD's dropout masks) come from `generator`; RON's
    loss samples its negatives with `draws` ([2, B, N] uniforms) or, if none
    are given, with `generator` after the forward. Metrics are 0-dim tensors
    on the device (reading one waits for the step)."""
    loss = detection_loss_fn(loss_config)

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None, draws=None):
        targets = encoder.batched(batch["gt_labels"], batch["gt_boxes"], batch["gt_valid"])
        params = list(state.params.values())
        for p in params:
            p.grad = None
        with pinned_precision(model):
            out = train_forward(model, batch["image"], generator)
            total, metrics = loss(out, targets, generator, draws)
            total.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        tx.step(params, grads, state.opt_state)
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
