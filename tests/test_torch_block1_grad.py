"""Gradients of the port's fused VGG block 1 (K-B) against `jax.grad` of the
JAX package's `fused_vgg_block1` (Pallas kernel in interpret mode, backward
by its recompute custom VJP), on the CPU, at f32.

The port's backward recomputes the unfused f32 composition and
differentiates it, as the JAX custom VJP does; differentiating the
bf16-rounded forward instead moves the gradients by several percent.
Tolerance: 1e-4 of each gradient's largest magnitude (f32 sums in another
order). Pooling ties route the gradient to one element of the window on
both sides (the first in row-major order); positive exact ties are rare on
random data, and a tied zero gets no gradient through the ReLU either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.kernels import fused_vgg_block1 as jax_fused_vgg_block1

from ron_tensorflow_tpu_torch.kernels import fused_vgg_block1
from ron_tensorflow_tpu_torch.kernels.fused_conv_pool import block1_reference

NAMES = ("x", "w1", "b1", "w2", "b2")


def block1_inputs(seed, shape, c=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, 3)).astype(np.float32)
    w1 = (rng.normal(size=(3, 3, 3, c)) * 0.2).astype(np.float32)
    b1 = rng.normal(size=(c,)).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, c, c)) * 0.1).astype(np.float32)
    b2 = rng.normal(size=(c,)).astype(np.float32)
    return x, w1, b1, w2, b2


def to_port(x, w1, b1, w2, b2):
    """numpy HWIO -> torch OIHW leaves that need gradients."""
    oihw = lambda w: torch.as_tensor(w).permute(3, 2, 0, 1).contiguous()
    return [t.requires_grad_() for t in (torch.as_tensor(x), oihw(w1), torch.as_tensor(b1), oihw(w2), torch.as_tensor(b2))]


def port_grads(args, g):
    leaves = to_port(*args)
    out = fused_vgg_block1(*leaves)
    (out * torch.as_tensor(g)).sum().backward()
    x, w1, b1, w2, b2 = (t.grad for t in leaves)
    hwio = lambda w: w.permute(2, 3, 1, 0).numpy()
    return x.numpy(), hwio(w1), b1.numpy(), hwio(w2), b2.numpy()


@pytest.mark.parametrize("shape", [(1, 16, 16), (2, 36, 52)])
def test_block1_grads_match_jax_custom_vjp(shape):
    args = block1_inputs(11, shape)
    g = np.random.default_rng(12).normal(size=(shape[0], shape[1] // 2, shape[2] // 2, 8)).astype(np.float32)

    def loss(*a):
        return jnp.sum(jax_fused_vgg_block1(*a, interpret=True) * g)

    ref = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    got = port_grads(args, g)
    for name, r, p in zip(NAMES, ref, got):
        r = np.asarray(r)
        assert p.shape == r.shape, name
        scale = float(np.abs(r).max())
        err = float(np.abs(p - r).max())
        assert err <= 1e-4 * scale, f"d{name}: max |port - jax| = {err:.3g}, {err / scale:.3g} of max |grad|"


def test_block1_saves_only_its_inputs():
    """The backward recomputes: exactly the five inputs are saved, no
    block-1 activation."""
    leaves = to_port(*block1_inputs(13, (1, 8, 8), c=64))
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fused_vgg_block1(*leaves)
    assert len(packed) == 5
    assert all(p is t or (p.data_ptr() == t.data_ptr() and p.shape == t.shape) for p, t in zip(packed, leaves))
    out.sum().backward()
    assert all(t.grad is not None for t in leaves)


def test_block1_under_inference_mode_has_no_grad_fn():
    leaves = to_port(*block1_inputs(14, (1, 8, 8), c=64))
    with torch.inference_mode():
        out = fused_vgg_block1(*leaves)
    assert out.grad_fn is None and not out.requires_grad
    with torch.no_grad():
        assert fused_vgg_block1(*leaves).grad_fn is None


def test_block1_reference_is_the_forward_up_to_bf16():
    """The recompute composition is the kernel's function before the bf16
    roundings: at f32 the plain forward sits within a few bf16 ulps of it."""
    args = block1_inputs(15, (1, 16, 16))
    leaves = [t.detach() for t in to_port(*args)]
    fwd = fused_vgg_block1(*leaves)
    ref = block1_reference(*leaves)
    assert fwd.shape == ref.shape == (1, 8, 8, 8)
    torch.testing.assert_close(fwd, ref, rtol=2e-2, atol=5e-2)
