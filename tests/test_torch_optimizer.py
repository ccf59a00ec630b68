"""The port's optimizers and schedules against optax (the JAX package's
`make_optimizer`), on the CPU.

Each of the seven optimizers under each of the four schedules, with warmup
and global-norm clipping that triggers on some steps, runs 5 steps on the
same parameters and gradients on both sides; the parameters agree within
1e-6 (float32 on both sides, the same operations in optax's order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ron_tensorflow_tpu.models.ron import RON as JaxRON
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.train.checkpoint import flatten_params, unflatten_params
from ron_tensorflow_tpu.train.optimizer import OptimizerConfig as JaxOptimizerConfig
from ron_tensorflow_tpu.train.optimizer import kernel_weight_decay_mask as jax_decay_mask
from ron_tensorflow_tpu.train.optimizer import make_learning_rate_schedule as jax_schedule
from ron_tensorflow_tpu.train.optimizer import make_optimizer as jax_make_optimizer

from ron_tensorflow_tpu_torch.models import get_network, layers
from ron_tensorflow_tpu_torch.train.optimizer import (
    OPTIMIZERS,
    OptimizerConfig,
    kernel_weight_decay_mask,
    make_learning_rate_schedule,
    make_optimizer,
)
from ron_tensorflow_tpu_torch.weights import jax_names, to_jax_layout

STEPS = 5
PARAM_TOL = 1e-6
SCHEDULES = {
    "fixed": dict(learning_rate_decay_type="fixed"),
    "exponential": dict(learning_rate_decay_type="exponential", decay_steps=2, learning_rate_decay_factor=0.5),
    "polynomial": dict(learning_rate_decay_type="polynomial", decay_steps=4, end_learning_rate=1e-4),
    # the last piece (1e-4) is floored at end_learning_rate
    "piecewise": dict(learning_rate_decay_type="piecewise", lr_boundaries=(2, 4), lr_factors=(1.0, 0.1, 0.01),
                      end_learning_rate=2e-4),
}


class Small(nn.Module):
    """Every kind of leaf the RON tree has: conv kernels with and without a
    bias, BN scale and bias, the 2x2 deconv's kernel and bias."""

    def __init__(self):
        super().__init__()
        self.a = layers.Conv(3, 4, norm=True)
        self.up = layers.ConvTranspose(4, 4)
        self.b = layers.Conv(4, 5)


def both_sides(cfg_kwargs, seed=0):
    model = Small()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.as_tensor(rng.normal(0, 0.5, p.shape).astype(np.float32)))
    names = jax_names(model)
    flax_tree = unflatten_params({names[n]: jnp.asarray(to_jax_layout(names[n], p))
                                  for n, p in model.named_parameters()})
    port = make_optimizer(OptimizerConfig(**cfg_kwargs), model)
    tx = jax_make_optimizer(JaxOptimizerConfig(**cfg_kwargs))
    return model, names, flax_tree, port, tx


def grads_at(model, step):
    """Per-step gradients; their global norm (~19 at scale 1) crosses the
    clip of 10 between steps."""
    rng = np.random.default_rng(100 + step)
    scale = 0.2 + 0.3 * step
    return [torch.as_tensor((rng.normal(0, 1, p.shape) * scale).astype(np.float32)) for p in model.parameters()]


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_optimizer_matches_optax(optimizer, schedule):
    cfg = dict(optimizer=optimizer, learning_rate=0.01, warmup_steps=3, clip_global_norm=10.0, weight_decay=5e-2,
               **SCHEDULES[schedule])
    model, names, params, port, tx = both_sides(cfg)
    opt_state = tx.init(params)
    tparams = list(model.parameters())
    state = port.init(tparams)
    for step in range(STEPS):
        grads = grads_at(model, step)
        gtree = unflatten_params({names[n]: jnp.asarray(to_jax_layout(names[n], g))
                                  for (n, _), g in zip(model.named_parameters(), grads)})
        updates, opt_state = tx.update(gtree, opt_state, params)
        params = optax.apply_updates(params, updates)
        port.step(tparams, grads, state)
    assert state["count"] == STEPS
    ref = flatten_params(params)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(to_jax_layout(names[n], p), np.asarray(ref[names[n]]), rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=n)


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("schedule", list(SCHEDULES) + ["reference default"])
def test_learning_rate_schedules_match_optax(schedule, warmup):
    kwargs = dict(SCHEDULES.get(schedule, {}), warmup_steps=warmup)
    port, ref = make_learning_rate_schedule(OptimizerConfig(**kwargs)), jax_schedule(JaxOptimizerConfig(**kwargs))
    for step in (0, 1, 2, 3, 4, 5, 7, 89999, 90000, 114999, 115000, 200000):
        got, want = port(step), np.asarray(ref(jnp.asarray(step, jnp.int32)))
        assert got.dtype == np.float32  # optax's constant schedule alone returns the Python float
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=0, err_msg=f"step {step}")


def test_decay_mask_equals_jax_on_the_ron_tree():
    """Decayed: exactly the leaves flax calls `kernel`; not the deconv's
    `deconv_kernel` and not BN's `scale`, though the port calls all three
    `weight`."""
    jmodel = JaxRON(spec=JAX_TINY_SPEC)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    ref = flatten_params(jax_decay_mask(shapes["params"]))
    model, _ = get_network("ron_tiny_vgg")
    names = jax_names(model)
    got = {names[n]: v for n, v in kernel_weight_decay_mask(model).items()}
    assert got == ref
    assert any(k.endswith("deconv_kernel") for k in got) and any(k.endswith("bn/scale") for k in got)
    assert sum(got.values()) == sum(1 for k in got if k.endswith("/kernel"))


def test_unknown_optimizer_and_schedule_raise():
    model = Small()
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(OptimizerConfig(optimizer="lamb"), model)
    with pytest.raises(ValueError, match="decay type"):
        make_learning_rate_schedule(OptimizerConfig(learning_rate_decay_type="cosine"))
    assert dataclasses.asdict(OptimizerConfig()) == {
        k: (tuple(v) if isinstance(v, list) else v) for k, v in dataclasses.asdict(JaxOptimizerConfig()).items()}
