"""The port's bf16 RON against the JAX package's bf16 RON, on the CPU, with
the same numpy-made weights, BN statistics and images on both sides; block
1 unfused, and fused (the JAX Pallas kernel in interpret mode, the port's
K-B plain version).

Tolerance, from a measurement on the tiny spec (this file's inputs): both
sides run every layer in bf16 but round at different places (XLA's CPU
convolutions against PyTorch's, the BN scale and shift, the reverse
connections' sums), so each lies 1-2.5% of an output's largest magnitude
from the f32 reference, and the two lie up to 2.5% of it from each other
(measured: 0.95-2.5%). A wrong weight, tap or layer moves outputs by tens
of percent. So:
- each output within 5e-2 of its largest magnitude of JAX's bf16 output;
- the port's bf16 no further from the f32 reference than 1.5 times JAX's
  bf16 (measured: at most 1.03 times).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.models.ron import RON as JaxRON
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.train.checkpoint import flatten_params, unflatten_params

from ron_tensorflow_tpu_torch import kernels
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC
from ron_tensorflow_tpu_torch.weights import from_jax_params

BF16_REL_TOL = 5e-2  # of each output's largest magnitude
F32_DISTANCE_RATIO = 1.5


@pytest.fixture(scope="module")
def tiny_bf16():
    """Numpy-seeded weights and BN statistics for the tiny spec, the JAX
    variables made from them, whitened-scale images and the f32 reference."""
    rng = np.random.default_rng(4)
    jmodel = JaxRON(spec=JAX_TINY_SPEC)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 64, 64, 3)), train=False)
    )
    params = {}
    for k, v in flatten_params(shapes["params"]).items():
        if k.endswith("kernel"):  # HWIO: fan-in scaled, so activations stay O(1)
            v = rng.normal(0.0, 1.0, v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        elif k.endswith("scale"):
            v = rng.uniform(0.5, 1.5, v.shape)
        else:
            v = rng.normal(0.0, 0.1, v.shape)
        params[k] = v.astype(np.float32)
    stats = {}
    for k, v in flatten_params(shapes["batch_stats"]).items():
        v = rng.normal(0.0, 0.1, v.shape) if k.endswith("mean") else rng.uniform(0.5, 1.5, v.shape)
        stats[k] = v.astype(np.float32)
    jvars = {
        "params": jax.tree.map(jnp.asarray, unflatten_params(params)),
        "batch_stats": jax.tree.map(jnp.asarray, unflatten_params(stats)),
    }
    images = (rng.uniform(0, 255, size=(2, 64, 64, 3)) - 120).astype(np.float32)  # VGG-mean scale
    with jax.default_matmul_precision("highest"):
        ref32 = jmodel.apply(jvars, jnp.asarray(images), train=False)
    return params, stats, jvars, images, [np.asarray(r) for r in ref32]


@pytest.mark.parametrize("fuse_block1", [False, True])
def test_bf16_outputs_match_jax_bf16(tiny_bf16, fuse_block1):
    params, stats, jvars, images, ref32 = tiny_bf16
    jmodel = JaxRON(spec=JAX_TINY_SPEC, dtype=jnp.bfloat16, fuse_block1=fuse_block1)
    ref = jmodel.apply(jvars, jnp.asarray(images), train=False)
    model = RON(RON_TINY_SPEC, dtype=torch.bfloat16, fuse_block1=fuse_block1)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = model(torch.as_tensor(images))
    assert kernels.launch_counts()["fused_vgg_block1"] == 0  # CPU tensors: the plain version
    for name, r, g, r32 in zip(ref._fields, ref, got, ref32):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32, name
        g = g.numpy()
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g, r, rtol=0, atol=BF16_REL_TOL * scale, err_msg=name)
        port_drift, jax_drift = np.abs(g - r32).max(), np.abs(r - r32).max()
        assert port_drift <= F32_DISTANCE_RATIO * jax_drift, (name, port_drift, jax_drift)
