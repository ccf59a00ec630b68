"""The port's box ops that the SSD crop uses, against the JAX package's
(`ron_tensorflow_tpu/ops/boxes.py`), on the CPU, after `tests/test_boxes.py`:
the same float32 arithmetic, so equal within 1e-7; masks equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.ops import boxes as jax_boxes

from ron_tensorflow_tpu_torch.ops import boxes

TOL = 1e-7


def random_boxes(seed, n=32, lo=-0.3, hi=1.3):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, (n, 4)).astype(np.float32)
    b = np.stack([np.minimum(a[:, 0], a[:, 2]), np.minimum(a[:, 1], a[:, 3]), np.maximum(a[:, 0], a[:, 2]),
                  np.maximum(a[:, 1], a[:, 3])], -1)
    b[:3] = ((0.2, 0.2, 0.2, 0.6), (0, 0, 0, 0), (-0.5, -0.5, -0.1, -0.1))  # empty, empty, outside
    return b


def same(got, ref, exact=False):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


REF_BOXES = [np.array([0.1, 0.2, 0.7, 0.6], np.float32), np.array([0.0, 0.0, 1.0, 1.0], np.float32),
             np.array([-0.2, 0.3, 0.5, 1.4], np.float32)]


@pytest.mark.parametrize("ref", range(3))
def test_intersection_with_ref_and_clip_to_ref(ref):
    b, r = random_boxes(ref), REF_BOXES[ref]
    same(boxes.intersection_with_ref(torch.as_tensor(r), torch.as_tensor(b)),
         jax_boxes.intersection_with_ref(jnp.asarray(r), jnp.asarray(b)))
    same(boxes.clip_to_ref(torch.as_tensor(b), torch.as_tensor(r)), jax_boxes.clip_to_ref(jnp.asarray(b), jnp.asarray(r)))
    # no ref box: the unit box, as before
    same(boxes.clip_to_ref(torch.as_tensor(b)), jax_boxes.clip_to_ref(jnp.asarray(b)))
    same(boxes.resize_to_ref(torch.as_tensor(r), torch.as_tensor(b)),
         jax_boxes.resize_to_ref(jnp.asarray(r), jnp.asarray(b)))


def test_batched_ref_boxes_broadcast():
    """One reference box per row of a batch, as the SSD crop uses them."""
    b = np.stack([random_boxes(s, n=10) for s in range(3)])
    refs = np.stack(REF_BOXES)
    got = boxes.resize_to_ref(torch.as_tensor(refs), torch.as_tensor(b)).numpy()
    got_i = boxes.intersection_with_ref(torch.as_tensor(refs), torch.as_tensor(b)).numpy()
    for i in range(3):
        same(got[i], jax_boxes.resize_to_ref(jnp.asarray(refs[i]), jnp.asarray(b[i])))
        same(got_i[i], jax_boxes.intersection_with_ref(jnp.asarray(refs[i]), jnp.asarray(b[i])))


def test_flip_and_center_corner():
    b = random_boxes(5)
    same(boxes.flip_left_right(torch.as_tensor(b)), jax_boxes.flip_left_right(jnp.asarray(b)), exact=True)
    centre = boxes.corner_to_center(torch.as_tensor(b))
    same(centre, jax_boxes.corner_to_center(jnp.asarray(b)), exact=True)
    same(boxes.center_to_corner(centre), jax_boxes.center_to_corner(jnp.asarray(centre.numpy())), exact=True)
    np.testing.assert_allclose(boxes.center_to_corner(centre).numpy(), b, atol=1e-6)


@pytest.mark.parametrize("margins", [(0.0, 0.0, 0.0, 0.0), (0.1, -0.1, 0.2, -0.05)])
def test_filter_center_mask_keeps_the_quirk(margins):
    b = random_boxes(6, n=64)
    b[3] = (0.2, 0.2, 2.6, 0.4)  # cy = 1.4 > 1: kept, the reference never tests cy's upper bound
    got = boxes.filter_center_mask(torch.as_tensor(b), margins)
    same(got, jax_boxes.filter_center_mask(jnp.asarray(b), margins), exact=True)
    assert bool(got[3]) == (margins[0] < 1.4 and 0.3 > margins[1])


@pytest.mark.parametrize("threshold", [0.5, 0.9])
def test_filter_overlap_mask(threshold):
    b = random_boxes(7, n=24)
    rng = np.random.default_rng(8)
    valid = rng.uniform(size=24) < 0.7
    same(boxes.filter_overlap_mask(torch.as_tensor(b), torch.as_tensor(valid), threshold),
         jax_boxes.filter_overlap_mask(jnp.asarray(b), jnp.asarray(valid), threshold), exact=True)
    # batched rows, each keeping its own best: here no box overlaps the unit box enough
    far = np.stack([b, np.clip(b, 0.0, 1.0) + 0.95])
    v = np.stack([valid, valid])
    got = boxes.filter_overlap_mask(torch.as_tensor(far), torch.as_tensor(v), threshold).numpy()
    for i in range(2):
        same(got[i], jax_boxes.filter_overlap_mask(jnp.asarray(far[i]), jnp.asarray(v[i]), threshold), exact=True)
        assert got[i].any()
    none = boxes.filter_overlap_mask(torch.as_tensor(b), torch.zeros(24, dtype=torch.bool), threshold)
    assert not bool(none.any())
