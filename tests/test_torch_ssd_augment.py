"""The port's SSD train augmentation and colour distortion against the JAX
package's, on the CPU, with JAX's own draws handed to the port's
`apply_augment` and `distort_color`.

Tolerances: images within 1e-5 on the [0, 1] scale, as
`test_torch_augment.py` holds the RON chain (XLA fuses a few float32
products and sums of the sample coordinates and of the YIQ rotation into
one rounding where torch takes two); boxes within 1e-6; labels and valid
flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.data import preprocess as jax_pre

from ron_tensorflow_tpu_torch.data import preprocess as port_pre

IMAGE_TOL = 1e-5
BOX_TOL = 1e-6
# distort_color's functions in the order ColorDraws names them, with their ranges
COLOR_RANGES = {"brightness": (-32.0 / 255.0, 32.0 / 255.0), "saturation": (0.5, 1.5), "hue": (-0.2, 0.2),
                "contrast": (0.5, 1.5)}
FIELDS = tuple(COLOR_RANGES)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_color_draws(key):
    """`distort_color`'s draws from its key (preprocess.py:372-424): the
    ordering from key 0, then the function at position p from key 1 + p."""
    ks = jax.random.split(key, 5)
    ordering = int(jax.random.randint(ks[0], (), 0, 4))
    values = {}
    for pos, field in enumerate(FIELDS[i - 1] for i in port_pre.COLOR_ORDERS[ordering]):
        lo, hi = COLOR_RANGES[field]
        values[field] = np.asarray(jax.random.uniform(ks[1 + pos], (), minval=lo, maxval=hi))
    return [np.int64(ordering)] + [values[f] for f in FIELDS]


def stack_color(per_image):
    return port_pre.ColorDraws(*(torch.as_tensor(np.stack([d[i] for d in per_image])) for i in range(5)))


def jax_ssd_draws(key, cfg, color):
    """`_ssd_train_augment`'s draws from `split(key, 6)` (preprocess.py:273-330)."""
    ks = jax.random.split(key, 6)
    k = cfg.patch_candidates
    return [jax.random.uniform(ks[0], (k,), minval=cfg.crop_aspect_range[0], maxval=cfg.crop_aspect_range[1]),
            jax.random.uniform(ks[1], (k,), minval=cfg.crop_area_range[0], maxval=cfg.crop_area_range[1]),
            jax.random.uniform(ks[2], (k, 2)), jax.random.uniform(ks[3])], (jax_color_draws(ks[4]) if color else None)


def make_batch(seed, batch=8, canvas=(48, 40), g=6, kind="random"):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (batch, *canvas, 3)).astype(np.float32)
    c = rng.uniform(0.15, 0.85, (batch, g, 2))
    s = rng.uniform(0.05, 0.6, (batch, g, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], -1).clip(0, 1).astype(np.float32)
    labels = rng.integers(1, 21, (batch, g)).astype(np.int32)
    valid = rng.uniform(size=(batch, g)) < 0.8
    if kind == "no valid gt":  # no crop can cover a gt: the whole image, no valid box out
        valid[:] = False
    elif kind == "tiny gts":  # few crops cover a quarter of one
        boxes[..., 2:] = boxes[..., :2] + 0.02
    return images, boxes, labels, valid


@pytest.mark.parametrize("out_shape", [(32, 24), (300, 300)])
@pytest.mark.parametrize("case", [(0, "random", None), (1, "random", False), (2, "no valid gt", None),
                                  (3, "tiny gts", None)])
def test_ssd_augment_matches_jax(case, out_shape):
    seed, kind, color = case
    images, boxes, labels, valid = make_batch(seed, kind=kind, batch=4 if out_shape[0] > 100 else 8)
    jcfg = jax_pre.PreprocessConfig(out_shape=out_shape, variant="ssd", color_distort=color)
    key = jax.random.PRNGKey(seed)
    ref = jax_pre.train_augment_batch(key, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(labels),
                                      jnp.asarray(valid), jcfg)
    per_image = [jax_ssd_draws(k, jcfg, color is not False) for k in jax.random.split(key, len(images))]
    draws = port_pre.SsdAugmentDraws(
        *(torch.as_tensor(np.stack([np.asarray(d[0][i]) for d in per_image])) for i in range(4)),
        stack_color([d[1] for d in per_image]) if color is not False else None)
    cfg = port_pre.PreprocessConfig(out_shape=out_shape, variant="ssd", color_distort=color)
    got = port_pre.apply_augment(draws, *(torch.as_tensor(a) for a in (images, boxes, labels, valid)), cfg)
    ref_img, ref_boxes, ref_labels, ref_valid = (np.asarray(a) for a in ref)
    assert got[0].shape == ref_img.shape and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy() / 255.0, ref_img / 255.0, rtol=0, atol=IMAGE_TOL)
    np.testing.assert_allclose(got[1].numpy(), ref_boxes, rtol=0, atol=BOX_TOL)
    np.testing.assert_array_equal(got[2].numpy(), ref_labels)
    np.testing.assert_array_equal(got[3].numpy(), ref_valid)
    if kind == "no valid gt":
        assert not ref_valid.any()
    else:
        assert ref_valid.any(-1).all()  # the overlap filter keeps at least one valid box
    if len(images) == 8 and kind == "random":  # both flip branches, and crops outside [0, 1] unclipped
        flipped = (draws.flip < 0.5).numpy()
        assert flipped.any() and (~flipped).any()
        assert (ref_boxes < 0).any() or (ref_boxes > 1).any()


def test_distort_color_matches_jax_in_every_order():
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (16, 20, 18, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), 16)
    ref = np.stack([np.asarray(jax_pre.distort_color(k, jnp.asarray(im))) for k, im in zip(keys, images)])
    draws = stack_color([jax_color_draws(k) for k in keys])
    assert set(draws.ordering.tolist()) == {0, 1, 2, 3}
    got = port_pre.distort_color(draws, torch.as_tensor(images)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=IMAGE_TOL)
    assert got.min() >= 0.0 and got.max() <= 1.0 and (got == 1.0).any()  # clipped


def test_ron_chain_with_color_distort_matches_jax():
    """The RON chain with `color_distort=True`: the distortion from key 7."""
    images, boxes, labels, valid = make_batch(9)
    jcfg = jax_pre.PreprocessConfig(out_shape=(32, 24), color_distort=True)
    key = jax.random.PRNGKey(9)
    ref = jax_pre.train_augment_batch(key, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(labels),
                                      jnp.asarray(valid), jcfg)
    keys = jax.random.split(key, len(images))
    per_image = []
    for k in keys:
        ks = jax.random.split(k, 8)
        r = jcfg.expand_ratio
        per_image.append([jax.random.uniform(ks[0]), jax.random.uniform(ks[1], (), minval=0.0, maxval=r - 1.0),
                          jax.random.uniform(ks[2], (), minval=0.0, maxval=r - 1.0),
                          jax.random.choice(ks[3], jnp.asarray(jcfg.min_ious)),
                          jax.random.uniform(ks[4], (16, 5, 2), minval=0.1, maxval=0.999),
                          jax.random.uniform(ks[5], (16, 2)), jax.random.uniform(ks[6])])
    draws = port_pre.AugmentDraws(*(torch.as_tensor(np.stack([np.asarray(d[i]) for d in per_image])) for i in range(7)),
                                  color=stack_color([jax_color_draws(jax.random.split(k, 8)[7]) for k in keys]))
    cfg = port_pre.PreprocessConfig(out_shape=(32, 24), color_distort=True)
    got = port_pre.apply_augment(draws, *(torch.as_tensor(a) for a in (images, boxes, labels, valid)), cfg)
    np.testing.assert_allclose(got[0].numpy() / 255.0, np.asarray(ref[0]) / 255.0, rtol=0, atol=IMAGE_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=BOX_TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_draw_augment_ssd_ranges_and_reproducibility():
    cfg = port_pre.PreprocessConfig(variant="ssd")
    a = port_pre.draw_augment(torch.Generator().manual_seed(3), 64, cfg)
    b = port_pre.draw_augment(torch.Generator().manual_seed(3), 64, cfg)
    assert torch.equal(a.aspect, b.aspect) and all(torch.equal(x, y) for x, y in zip(a.color, b.color))
    assert a.aspect.shape == a.area.shape == (64, 16) and a.offset.shape == (64, 16, 2)
    assert 0.6 <= float(a.aspect.min()) and float(a.aspect.max()) < 1.67
    assert 0.1 <= float(a.area.min()) and float(a.area.max()) < 1.0
    assert set(a.color.ordering.tolist()) == {0, 1, 2, 3}
    for field, (lo, hi) in COLOR_RANGES.items():
        v = getattr(a.color, field)
        assert lo <= float(v.min()) and float(v.max()) < hi, field
    assert port_pre.draw_augment(torch.Generator(), 2, port_pre.PreprocessConfig(variant="ssd", color_distort=False)
                                 ).color is None
    with pytest.raises(ValueError, match="variant"):
        port_pre.draw_augment(torch.Generator(), 2, port_pre.PreprocessConfig(variant="yolo"))
