"""The port's exact_top_k_chunked must give jax.lax.top_k's values,
indices, order and tie resolution (ties to the smallest index) — the
property tests/test_topk.py pins for the JAX version. torch.topk does not
promise that tie order, so this is the port's own hazard."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu_torch.ops.math import exact_top_k_chunked


def assert_same(x, k, num_chunks):
    v1, i1 = jax.lax.top_k(jnp.asarray(x), k)
    v2, i2 = exact_top_k_chunked(torch.as_tensor(x), k, num_chunks)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))


@pytest.mark.parametrize("num_chunks", [1, 5, 16])
@pytest.mark.parametrize("n,k", [(2125, 200), (997, 100), (50, 50), (21250, 200), (8732, 400), (24564, 400)])
def test_matches_lax_top_k_random(n, k, num_chunks):
    rng = np.random.default_rng(n * 1000 + k + num_chunks)
    assert_same(rng.normal(size=n).astype(np.float32), k, num_chunks)


@pytest.mark.parametrize("num_chunks", [1, 4, 7])
def test_adversarial_ties(num_chunks):
    rng = np.random.default_rng(0)
    for distinct in (1, 2, 5):
        x = rng.choice(rng.normal(size=distinct), size=3000).astype(np.float32)
        assert_same(x, 250, num_chunks)


def test_masked_detection_scores_batched():
    """The detector's shape: [B, C-1, N] scores, mostly exact zeros (masked
    candidates), plus -inf entries and rows with fewer positives than k."""
    rng = np.random.default_rng(1)
    x = np.where(rng.random((2, 3, 4000)) < 0.95, 0.0, rng.random((2, 3, 4000))).astype(np.float32)
    x[0, 1, 100:150] = -np.inf
    assert_same(x, 200, 16)
