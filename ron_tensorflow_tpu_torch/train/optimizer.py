"""Optimizers and learning-rate schedules, as plain functions on tensors.

Port of `ron_tensorflow_tpu/train/optimizer.py`, which builds optax chains
(ref: tf_utils.py:92-171, ron_net.py:354-356). The update runs in optax's
order: clip by global norm -> weight decay on the masked tensors -> the
optimizer's core -> times -lr(count), the count starting at 0. Each core is
written out as optax computes it (not `torch.optim`, whose eps placement,
Adagrad accumulator and all-parameter weight decay differ). FTRL folds the
learning rate into its own rule and takes neither clipping nor schedule
(optimizer.py:163-176).

Weight decay applies where JAX's `kernel_weight_decay_mask` is True: where
the flax leaf is `kernel` (conv kernels), not `deconv_kernel` and not BN's
`scale`, although the port names all three `weight`. The mask comes from
the flax names (`weights.jax_names`).

Schedules return float32 values (numpy), as the jnp schedules do. Updates
happen in place on the parameters (`Optimizer.step`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..parallel.collectives import all_reduce_sum
from ..weights import jax_names


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Mirrors the reference's optimization flags (ref: ron_net.py:66-150)."""

    optimizer: str = "momentum"
    learning_rate: float = 1e-3
    end_learning_rate: float = 1e-6
    learning_rate_decay_type: str = "piecewise"  # fixed|exponential|polynomial|piecewise
    learning_rate_decay_factor: float = 0.1
    decay_steps: int = 90000
    lr_boundaries: Sequence[int] = (90000, 115000)
    lr_factors: Sequence[float] = (1.0, 0.1, 0.001)
    momentum: float = 0.9
    weight_decay: float = 5e-4
    # linear warmup from 0 over the first N steps (0 = off); not a reference flag
    warmup_steps: int = 0
    # global-norm gradient clipping (0 = off); not a reference flag
    clip_global_norm: float = 0.0
    # per-optimizer knobs (reference flag defaults, ref: ron_net.py:66-145)
    adadelta_rho: float = 0.95
    adagrad_initial_accumulator_value: float = 0.1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    opt_epsilon: float = 1.0
    ftrl_learning_rate_power: float = -0.5
    ftrl_initial_accumulator_value: float = 0.1
    ftrl_l1: float = 0.0
    ftrl_l2: float = 0.0
    rmsprop_decay: float = 0.9
    rmsprop_momentum: float = 0.9


OPTIMIZERS = ("adadelta", "adagrad", "adam", "ftrl", "momentum", "rmsprop", "sgd")
_f32 = np.float32


def make_learning_rate_schedule(cfg: OptimizerConfig) -> Callable[[int], np.float32]:
    """step -> learning rate, float32 (ref: tf_utils.py:92-124 +
    ron_net.py:354-356), times min(1, (step + 1) / warmup) with a warmup."""
    base = _base_schedule(cfg)
    if not cfg.warmup_steps:
        return base
    return lambda step: _f32(min(_f32(1.0), _f32(step + 1) / _f32(cfg.warmup_steps))) * base(step)


def _base_schedule(cfg: OptimizerConfig) -> Callable[[int], np.float32]:
    kind = cfg.learning_rate_decay_type
    if kind == "fixed":
        return lambda step: _f32(cfg.learning_rate)
    if kind == "exponential":  # optax.exponential_decay(staircase=True)
        if cfg.decay_steps <= 0 or cfg.learning_rate_decay_factor == 0:
            return lambda step: _f32(cfg.learning_rate)

        def exponential(step):
            if step <= 0:
                return _f32(cfg.learning_rate)
            p = np.floor(_f32(step) / _f32(cfg.decay_steps))
            return _f32(cfg.learning_rate) * np.power(_f32(cfg.learning_rate_decay_factor), p)

        return exponential
    if kind == "polynomial":  # optax.polynomial_schedule(power=1)
        if cfg.decay_steps <= 0:
            return lambda step: _f32(cfg.learning_rate)

        def polynomial(step):
            frac = _f32(1) - _f32(min(max(step, 0), cfg.decay_steps)) / _f32(cfg.decay_steps)
            return _f32(cfg.learning_rate - cfg.end_learning_rate) * frac + _f32(cfg.end_learning_rate)

        return polynomial
    if kind == "piecewise":
        values = [cfg.learning_rate * f for f in cfg.lr_factors]

        def piecewise(step):
            lr = values[0]
            for boundary, value in zip(cfg.lr_boundaries, values[1:]):
                if step >= boundary:
                    lr = value
            # floored at end_learning_rate (ref: ron_net.py:356 tf.maximum)
            return max(_f32(lr), _f32(cfg.end_learning_rate))

        return piecewise
    raise ValueError(f"unknown decay type {kind!r}")


def kernel_weight_decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """{parameter name: decayed?}: True where the flax leaf is `kernel`,
    JAX `kernel_weight_decay_mask` (optimizer.py:145-150)."""
    names = jax_names(model)
    return {n: names[n].rsplit("/", 1)[-1] == "kernel" for n, _ in model.named_parameters()}


def global_norm(tensors, sharded: Optional[Sequence[bool]] = None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm), from
    one multi-tensor norm, accumulated in float64 and returned as float32:
    a float32 sum over a tensor of millions of values strays by 1e-4
    relative on the CPU, and would differ between a whole tensor and its
    slices. Over a mesh, the tensors marked in `sharded` are a model rank's
    slices: their squares are summed over the model `group` (one
    all-reduce), so the norm is the whole tensors' on every rank."""
    squares = torch.stack(torch._foreach_norm(list(tensors), 2, dtype=torch.float64)) ** 2
    if group is not None and any(sharded or ()):
        mask = torch.tensor(list(sharded), device=squares.device)
        squares = torch.cat([torch.where(mask, 0.0, squares),
                             all_reduce_sum(torch.where(mask, squares, 0.0).sum()[None], group)])
    return torch.sqrt(squares.sum()).float()


def _moment(g, m, decay, order):
    """optax's (1 - decay) * g^order + decay * m, in place on m."""
    return m.mul_(decay).add_((1.0 - decay) * (g * g if order == 2 else g))


def _bias_correction(decay: float, count: int) -> float:
    return float(_f32(1) - _f32(decay) ** count)


class Optimizer:
    """The update chain of the JAX `make_optimizer(cfg)` for a list of
    parameters.

    `init(params)` -> state (a dict of tensor lists and the int `count`);
    `step(params, grads, state)` adds optax's update to the parameters and
    updates the state, both in place. `decay_mask` lists, parameter by
    parameter, whether weight decay applies. The cores take their input
    without changing it (it may be the gradients themselves)."""

    def __init__(self, cfg: OptimizerConfig, decay_mask: Sequence[bool]):
        if cfg.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.decay_mask = list(decay_mask)
        self.schedule = make_learning_rate_schedule(cfg)

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        cfg, zeros = self.cfg, lambda: [torch.zeros_like(p) for p in params]
        state = {"count": 0}
        if cfg.optimizer == "adadelta":
            state.update(e_g=zeros(), e_x=zeros())
        elif cfg.optimizer == "adagrad":
            state["sum_of_squares"] = [torch.full_like(p, cfg.adagrad_initial_accumulator_value) for p in params]
        elif cfg.optimizer == "adam":
            state.update(mu=zeros(), nu=zeros())
        elif cfg.optimizer == "ftrl":
            state.update(accum=[torch.full_like(p, cfg.ftrl_initial_accumulator_value) for p in params],
                         linear=zeros())
        elif cfg.optimizer == "momentum":
            state["trace"] = zeros()
        elif cfg.optimizer == "rmsprop":
            state.update(nu=zeros(), trace=zeros())
        return state

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: Dict,
             norm: Optional[torch.Tensor] = None) -> None:
        """params += update, in place: clip, decay, the core (its state
        updated in place), then times -lr(count), added to the parameters
        by multi-tensor kernels. FTRL's core output is the update itself.
        `norm`: the gradients' global norm where the caller has it (over a
        mesh only the caller can compute it); else computed here."""
        cfg = self.cfg
        u = [g.float() for g in grads]
        if cfg.clip_global_norm and cfg.optimizer != "ftrl":
            norm = global_norm(u) if norm is None else norm
            keep = norm < cfg.clip_global_norm
            u = [torch.where(keep, t, t / norm * cfg.clip_global_norm) for t in u]
        decayed = [i for i, d in enumerate(self.decay_mask) if d]
        if cfg.weight_decay and decayed:
            for i, t in zip(decayed, torch._foreach_add([u[i] for i in decayed], [params[i] for i in decayed],
                                                        alpha=cfg.weight_decay)):
                u[i] = t
        u = getattr(self, f"_{cfg.optimizer}")(u, state, params)
        count = state["count"]
        state["count"] = count + 1
        if cfg.optimizer == "ftrl":
            torch._foreach_add_(list(params), u)
        else:
            torch._foreach_add_(list(params), u, alpha=float(-self.schedule(count)))

    # ---- cores: updates in, updates out; state in place ---- #

    def _adadelta(self, u, state, params):
        rho, eps = self.cfg.adadelta_rho, self.cfg.opt_epsilon
        out = []
        for g, e_g, e_x in zip(u, state["e_g"], state["e_x"]):
            _moment(g, e_g, rho, 2)
            step = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
            _moment(step, e_x, rho, 2)
            out.append(step)
        return out

    def _adagrad(self, u, state, params):
        out = []
        for g, sos in zip(u, state["sum_of_squares"]):
            sos.add_(g * g)
            out.append(torch.where(sos > 0, torch.rsqrt(sos + 1e-7), 0.0) * g)
        return out

    def _adam(self, u, state, params):
        cfg = self.cfg
        n = state["count"] + 1
        c1, c2 = _bias_correction(cfg.adam_beta1, n), _bias_correction(cfg.adam_beta2, n)
        out = []
        for g, mu, nu in zip(u, state["mu"], state["nu"]):
            _moment(g, mu, cfg.adam_beta1, 1)
            _moment(g, nu, cfg.adam_beta2, 2)
            out.append((mu / c1) / (torch.sqrt(nu / c2) + cfg.opt_epsilon))
        return out

    def _ftrl(self, u, state, params):
        """TF's FtrlOptimizer rule, as the JAX package writes it (optimizer.py:116-142)."""
        cfg = self.cfg
        lr, power, l1, l2 = cfg.learning_rate, cfg.ftrl_learning_rate_power, cfg.ftrl_l1, cfg.ftrl_l2
        out = []
        for g, accum, linear, p in zip(u, state["accum"], state["linear"], params):
            new_accum = accum + g * g
            sigma = (new_accum ** -power - accum ** -power) / lr
            linear.copy_(linear + g - sigma * p)
            quad = new_accum ** -power / lr + 2.0 * l2
            new_p = torch.where(linear.abs() > l1, -(linear - torch.sign(linear) * l1) / quad, 0.0)
            accum.copy_(new_accum)
            out.append(new_p - p)
        return out

    def _momentum(self, u, state, params):
        trace = state["trace"]
        torch._foreach_mul_(trace, self.cfg.momentum)
        torch._foreach_add_(trace, u)
        return trace

    def _rmsprop(self, u, state, params):
        cfg = self.cfg
        out = []
        for g, nu, t in zip(u, state["nu"], state["trace"]):
            _moment(g, nu, cfg.rmsprop_decay, 2)
            out.append(t.mul_(cfg.rmsprop_momentum).add_(torch.rsqrt(nu + cfg.opt_epsilon) * g))
        return out

    def _sgd(self, u, state, params):
        return u


def make_optimizer(cfg: OptimizerConfig, model: torch.nn.Module) -> Optimizer:
    """The chain for `model`'s parameters, in `named_parameters()` order,
    with the flax-name weight-decay mask."""
    mask = kernel_weight_decay_mask(model)
    return Optimizer(cfg, [mask[n] for n, _ in model.named_parameters()])

