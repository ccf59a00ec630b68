"""The port's target encoder against the JAX package's, on the CPU.

`dual_max_match` must give JAX's and a brute-force oracle's match indices
bit for bit (crowded scenes, duplicate-gt ties); `TargetEncoder.batched`
equal labels, matched IoUs and locations within 1e-6 (both sides compute
in float32 with the same operations; XLA may fold a division by a constant
into another rounding), at the tiny spec and the RON-320 layout. The IoU is
held bit for bit to XLA's fused one (the jitted `iou_matrix`), whose union
takes one fused multiply-add: an IoU one ulp off can flip a label.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.models.ron import RON_320_SPEC as JAX_320_SPEC
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.ops import boxes as jax_boxes
from ron_tensorflow_tpu.ops import encode as jax_encode

from ron_tensorflow_tpu_torch.ops import boxes as port_boxes
from ron_tensorflow_tpu_torch.ops import encode as port_encode
from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC, RON_TINY_SPEC

MAX_GT = 56  # the input pipeline's gt pad
LOC_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: its CPU steps share the
    cores with the other test workers, and eight spinning threads a worker
    slow all of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def crowded_scene(rng, n_valid=48, n_classes=20, clusters=True):
    """A copy of tests/test_crowded.py's scene: [MAX_GT] labels, boxes,
    valid with overlapping same-class clusters, tiny boxes and one exact
    duplicate pair (indices 1 and n_valid - 1: an IoU tie)."""
    boxes = np.zeros((MAX_GT, 4), np.float32)
    labels = np.zeros((MAX_GT,), np.int32)
    valid = np.zeros((MAX_GT,), bool)
    i = 0
    while i < n_valid:
        if clusters and i + 4 <= n_valid and rng.uniform() < 0.4:
            cls = 1 + int(rng.integers(n_classes))
            cy, cx = rng.uniform(0.2, 0.8, 2)
            s = rng.uniform(0.08, 0.2)
            for _ in range(4):
                dy, dx = rng.uniform(-0.04, 0.04, 2)
                y0 = np.clip(cy + dy - s / 2, 0, 1)
                x0 = np.clip(cx + dx - s / 2, 0, 1)
                boxes[i] = (y0, x0, min(y0 + s, 1.0), min(x0 + s, 1.0))
                labels[i] = cls
                valid[i] = True
                i += 1
        else:
            s = rng.choice([0.02, 0.05, 0.15, 0.4])
            y0, x0 = rng.uniform(0, 1 - s, 2)
            boxes[i] = (y0, x0, y0 + s, x0 + s)
            labels[i] = 1 + int(rng.integers(n_classes))
            valid[i] = True
            i += 1
    boxes[n_valid - 1] = boxes[1]
    labels[n_valid - 1] = labels[1]
    return labels, boxes, valid


def _np_dual_max(overlap, valid, pos_t, ign_t):
    """A copy of tests/test_crowded.py's brute-force oracle of dual_max_match
    (ref: ssd_common.py:47-75): walking the gts high to low lets the lowest
    claiming index win."""
    g, n = overlap.shape
    a2g = overlap.argmax(axis=0)
    best = overlap.max(axis=0)
    match = np.where(best < ign_t, -1, a2g)
    match = np.where((best >= ign_t) & (best < pos_t), -2, match)
    for gi in range(g - 1, -1, -1):
        if valid[gi]:
            match[overlap[gi].argmax()] = gi
    return match


def scene(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "crowded":
        return crowded_scene(rng, 48)
    if kind == "crowded, no clusters":
        return crowded_scene(rng, 40, clusters=False)
    if kind == "sparse":
        return crowded_scene(rng, 3, clusters=False)
    if kind == "duplicates":  # every gt twice: each pair ties on every anchor
        labels, boxes, valid = crowded_scene(rng, 20, clusters=False)
        labels[20:40], boxes[20:40], valid[20:40] = labels[:20], boxes[:20], valid[:20]
        return labels, boxes, valid
    if kind == "none valid":
        labels, boxes, _ = crowded_scene(rng, 8)
        return labels, np.zeros_like(boxes), np.zeros(MAX_GT, bool)
    raise ValueError(kind)


SCENES = ["crowded", "crowded, no clusters", "sparse", "duplicates", "none valid"]
SPECS = {"tiny": (JAX_TINY_SPEC, RON_TINY_SPEC), "ron_320": (JAX_320_SPEC, RON_320_SPEC)}


def overlaps(spec, labels, boxes, valid):
    """The encoder's border- and validity-masked [G, N] IoU, from JAX."""
    layout = spec.anchor_layout()
    inside = jax_encode.anchor_inside_mask(layout, spec.img_shape)
    ov = np.array(jax.jit(jax_boxes.iou_matrix)(jnp.asarray(boxes), jnp.asarray(layout.corners)))
    return ov * inside.astype(np.float32)[None, :] * valid.astype(np.float32)[:, None]


@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("kind", SCENES)
def test_dual_max_match_bit_equal_to_jax_and_oracle(spec_name, kind):
    jspec, _ = SPECS[spec_name]
    labels, boxes, valid = scene(kind, 7)
    ov = overlaps(jspec, labels, boxes, valid)
    ref_idx, ref_scores = (np.asarray(a) for a in jax_encode.dual_max_match(jnp.asarray(ov), jnp.asarray(valid),
                                                                             0.56, 0.3))
    got_idx, got_scores = port_encode.dual_max_match(torch.as_tensor(ov), torch.as_tensor(valid), 0.56, 0.3)
    np.testing.assert_array_equal(got_idx.numpy(), ref_idx)
    np.testing.assert_array_equal(got_idx.numpy(), _np_dual_max(ov, valid, 0.56, 0.3))
    np.testing.assert_array_equal(got_scores.numpy(), ref_scores)
    if kind == "duplicates":  # of each tied pair only the lower index is ever matched
        assert not np.isin(np.arange(20, 40), got_idx.numpy()).any()


def test_dual_max_match_batched_rows_are_independent():
    """[B, G, N] at once equals each image alone."""
    ovs, valids = [], []
    for seed, kind in enumerate(SCENES):
        labels, boxes, valid = scene(kind, seed)
        ovs.append(overlaps(JAX_TINY_SPEC, labels, boxes, valid))
        valids.append(valid)
    ov, valid = torch.as_tensor(np.stack(ovs)), torch.as_tensor(np.stack(valids))
    idx, scores = port_encode.dual_max_match(ov, valid, 0.5, 0.3)
    for b in range(len(SCENES)):
        i1, s1 = port_encode.dual_max_match(ov[b], valid[b], 0.5, 0.3)
        assert torch.equal(idx[b], i1) and torch.equal(scores[b], s1)


def test_anchor_inside_mask_and_iou_equal_jax():
    for jspec, spec in SPECS.values():
        np.testing.assert_array_equal(
            port_encode.anchor_inside_mask(spec.anchor_layout(), spec.img_shape),
            np.asarray(jax_encode.anchor_inside_mask(jspec.anchor_layout(), jspec.img_shape)))
    _, boxes, _ = scene("crowded", 3)
    corners = RON_320_SPEC.anchor_layout().corners
    ref = np.asarray(jax.jit(jax_boxes.iou_matrix)(jnp.asarray(boxes), jnp.asarray(corners)))
    got = port_boxes.iou_matrix(torch.as_tensor(boxes), torch.as_tensor(corners)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("thresholds", [(0.56, 0.3), (0.5, 0.5)])
def test_target_encoder_batched_matches_jax(spec_name, thresholds):
    jspec, spec = SPECS[spec_name]
    scenes = [scene(kind, 11 + i) for i, kind in enumerate(SCENES)]
    labels, boxes, valid = (np.stack(a) for a in zip(*scenes))
    pos_t, ign_t = thresholds
    jenc = jax_encode.TargetEncoder(jspec.anchor_layout(), jspec.img_shape, pos_t, ign_t, jspec.prior_scaling)
    ref = jenc.batched(jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid))
    enc = port_encode.TargetEncoder(spec.anchor_layout(), spec.img_shape, pos_t, ign_t, spec.prior_scaling)
    got = enc.batched(torch.as_tensor(labels), torch.as_tensor(boxes), torch.as_tensor(valid))
    assert got.labels.dtype == torch.int32 and got.locations.shape == (len(scenes), spec.anchor_layout().num_anchors, 4)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.locations.numpy(), np.asarray(ref.locations), rtol=0, atol=LOC_TOL)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=LOC_TOL)
    assert torch.isfinite(got.locations).all()  # unmatched anchors: log(ah/ah) = 0, not NaN
    assert bool((got.locations[got.labels <= 0] == 0).all())
    seen = set(got.labels.unique().tolist())
    assert 0 in seen and len(seen - {-1, 0}) > 1  # negatives and positives of several classes
    assert (-1 in seen) == (pos_t > ign_t)  # the ignore band, where there is one


def test_target_encoder_one_image_equals_batched_row():
    labels, boxes, valid = scene("crowded", 5)
    enc = port_encode.TargetEncoder(RON_320_SPEC.anchor_layout(), (320, 320), 0.56, 0.3)
    one = enc(labels, boxes, valid)
    batch = enc.batched(labels[None], boxes[None], valid[None])
    for a, b in zip(one, batch):
        assert torch.equal(a, b[0])


def test_prior_scaling_index_convention():
    """Channel 0 (cx) divides by s0 and channel 1 (cy) by s1, 2 (w) by s2,
    3 (h) by s3, as JAX's encoder does, for any scaling."""
    labels, boxes, valid = scene("crowded", 2)
    scaling = (0.1, 0.3, 0.2, 0.4)
    jenc = jax_encode.TargetEncoder(JAX_TINY_SPEC.anchor_layout(), (64, 64), 0.5, 0.3, scaling)
    enc = port_encode.TargetEncoder(RON_TINY_SPEC.anchor_layout(), (64, 64), 0.5, 0.3, scaling)
    ref = jenc(jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid))
    got = enc(labels, boxes, valid)
    np.testing.assert_allclose(got.locations.numpy(), np.asarray(ref.locations), rtol=0, atol=LOC_TOL)
    jax.block_until_ready(ref.labels)
