"""The port's heavy VGG variant (fc6 a 7x7 conv with 4096 channels, fc7 a
1x1 conv with 4096) against the JAX package's, on the CPU: the tiny RON
with `backbone_variant="heavy"`, the same numpy-made weights, BatchNorm
statistics and images on both sides.

Tolerance: float32 on both sides (JAX under
`default_matmul_precision("highest")`), summation order only: within 1e-4
of each output's largest magnitude, as `test_torch_model.py` holds the
reduced tiny RON.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.models.ron import RON as JaxRON
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.train.checkpoint import flatten_params, unflatten_params

from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC
from ron_tensorflow_tpu_torch.models.testing import seeded_flax_params
from ron_tensorflow_tpu_torch.weights import from_jax_params

F32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_heavy_tiny_ron_matches_jax():
    model = RON(RON_TINY_SPEC, backbone_variant="heavy")
    assert model.backbone.fc6.conv.weight.shape == (4096, 512, 7, 7)
    assert model.block7_reverse.conv_left.conv.weight.shape == (512, 4096, 2, 2)
    assert model.block6_reverse.conv_left.conv.weight.shape == (512, 4096, 3, 3)
    params, stats = seeded_flax_params(model, seed=11)
    jmodel = JaxRON(spec=JAX_TINY_SPEC, backbone_variant="heavy")
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    assert {k: v.shape for k, v in params.items()} == {k: v.shape for k, v in flatten_params(shapes["params"]).items()}
    assert stats.keys() == flatten_params(shapes["batch_stats"]).keys()
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    images = (np.random.default_rng(12).uniform(0, 255, (2, 64, 64, 3)) - 120).astype(np.float32)
    jvars = {"params": jax.tree.map(jnp.asarray, unflatten_params(params)),
             "batch_stats": jax.tree.map(jnp.asarray, unflatten_params(stats))}
    with jax.default_matmul_precision("highest"):
        ref = jmodel.apply(jvars, jnp.asarray(images), train=False)
    with torch.no_grad():
        got = model(torch.as_tensor(images))
    for field, r, g in zip(got._fields, ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape, field
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=F32_TOL * float(np.abs(r).max()), err_msg=field)
