"""The port's RON train augmentation against the JAX package's, on the CPU,
with JAX's draws handed to the port's `apply_augment`.

Tolerances: boxes within 1e-6, labels and valid flags equal. Images within
1e-5 of the [0, 1] range (2.55e-3 on the whitened scale): the warp's sample
coordinates come out of a few float32 products and sums that XLA may fuse
(one rounding where torch takes two), and on these noise images a one-ulp
shift of a coordinate moves an output pixel by up to ~5e-6. Given the same
coordinates, the warp itself agrees within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.data import preprocess as jax_pre

from ron_tensorflow_tpu_torch.data import preprocess as port_pre

IMAGE_TOL = 1e-5  # on the [0, 1] scale
BOX_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: its CPU steps share the
    cores with the other test workers, and eight spinning threads a worker
    slow all of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_draws(key, cfg: jax_pre.PreprocessConfig):
    """The seven draws `train_augment` takes from `split(key, 8)`
    (preprocess.py:164-193)."""
    ks = jax.random.split(key, 8)
    r = cfg.expand_ratio
    return [
        jax.random.uniform(ks[0]),
        jax.random.uniform(ks[1], (), minval=0.0, maxval=r - 1.0),
        jax.random.uniform(ks[2], (), minval=0.0, maxval=r - 1.0),
        jax.random.choice(ks[3], jnp.asarray(cfg.min_ious)),
        jax.random.uniform(ks[4], (cfg.patch_candidates, cfg.aspect_attempts, 2), minval=0.1, maxval=0.999),
        jax.random.uniform(ks[5], (cfg.patch_candidates, 2)),
        jax.random.uniform(ks[6]),
    ]


def batch_draws(key, batch, cfg):
    """`train_augment_batch`'s draws: one key an image, from `split(key, B)`."""
    per_image = [jax_draws(k, cfg) for k in jax.random.split(key, batch)]
    return port_pre.AugmentDraws(*(torch.as_tensor(np.stack([np.asarray(d[i]) for d in per_image]))
                                   for i in range(7)))


def make_batch(seed, batch=8, canvas=(48, 40), g=6, kind="random"):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (batch, *canvas, 3)).astype(np.float32)
    c = rng.uniform(0.2, 0.8, (batch, g, 2))
    s = rng.uniform(0.05, 0.5, (batch, g, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], -1).clip(0, 1).astype(np.float32)
    labels = rng.integers(1, 21, (batch, g)).astype(np.int32)
    valid = rng.uniform(size=(batch, g)) < 0.8
    if kind == "no valid gt":  # no candidate can take a centre: the whole canvas
        valid[:] = False
    elif kind == "one large gt":
        boxes[:, 0] = (0.05, 0.05, 0.95, 0.95)
        valid[:, 1:] = False
    return images, boxes, labels, valid


@pytest.mark.parametrize("out_shape", [(32, 24), (320, 320)])
@pytest.mark.parametrize("case", [(0, "random"), (1, "random"), (2, "no valid gt"), (3, "one large gt")])
def test_apply_augment_matches_jax(case, out_shape):
    seed, kind = case
    images, boxes, labels, valid = make_batch(seed, kind=kind, batch=4 if out_shape[0] > 100 else 8)
    jcfg = jax_pre.PreprocessConfig(out_shape=out_shape)
    key = jax.random.PRNGKey(seed)
    ref = jax_pre.train_augment_batch(key, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(labels),
                                      jnp.asarray(valid), jcfg)
    draws = batch_draws(key, len(images), jcfg)
    got = port_pre.apply_augment(draws, torch.as_tensor(images), torch.as_tensor(boxes), torch.as_tensor(labels),
                                 torch.as_tensor(valid), port_pre.PreprocessConfig(out_shape=out_shape))
    ref_img, ref_boxes, ref_labels, ref_valid = (np.asarray(a) for a in ref)
    assert got[0].shape == ref_img.shape and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy() / 255.0, ref_img / 255.0, rtol=0, atol=IMAGE_TOL)
    np.testing.assert_allclose(got[1].numpy(), ref_boxes, rtol=0, atol=BOX_TOL)
    np.testing.assert_array_equal(got[2].numpy(), ref_labels)
    np.testing.assert_array_equal(got[3].numpy(), ref_valid)
    if kind == "no valid gt":
        assert not ref_valid.any()
    expanded, flipped = (draws.expand < 0.5).numpy(), (draws.flip < 0.5).numpy()
    if len(images) == 8:  # both branches of expand and flip are taken in the batch
        assert expanded.any() and (~expanded).any() and flipped.any() and (~flipped).any()


def test_warp_matches_jax_given_the_coordinates():
    """Sample points inside, on the edge and outside the source (mean fill)."""
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 1, (48, 40, 3)).astype(np.float32)
    ys = np.sort(rng.uniform(-0.2, 1.1, 32)).astype(np.float32)
    xs = np.sort(rng.uniform(-0.1, 1.2, 24)).astype(np.float32)
    ys[:3] = (0.0, 1.0, 0.5 / 48)
    fill = image.mean((0, 1))
    ref = np.asarray(jax_pre._bilinear_warp_separable(jnp.asarray(image), jnp.asarray(ys), jnp.asarray(xs),
                                                      jnp.asarray(fill)))
    got = port_pre._bilinear_warp_separable(torch.as_tensor(image)[None], torch.as_tensor(ys)[None],
                                            torch.as_tensor(xs)[None], torch.as_tensor(fill)[None])[0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_roi_jaccard_matches_jax():
    rng = np.random.default_rng(1)
    roi = np.array([0.1, 0.2, 0.6, 0.7], np.float32)
    boxes = rng.uniform(0, 1, (20, 4)).astype(np.float32)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2])
    boxes[0] = 0.0  # empty box and roi corner cases
    ref = np.asarray(jax_pre._roi_jaccard(jnp.asarray(roi), jnp.asarray(boxes)))
    got = port_pre._roi_jaccard(torch.as_tensor(roi), torch.as_tensor(boxes)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)


def test_draw_augment_ranges_and_reproducibility():
    cfg = port_pre.PreprocessConfig()
    a = port_pre.draw_augment(torch.Generator().manual_seed(3), 64, cfg)
    b = port_pre.draw_augment(torch.Generator().manual_seed(3), 64, cfg)
    assert a.color is None  # RON's chain draws no colour distortion by default
    assert all(torch.equal(x, y) for x, y in zip(a[:-1], b[:-1]))
    assert a.wh.shape == (64, cfg.patch_candidates, cfg.aspect_attempts, 2) and a.patch.shape == (64, 16, 2)
    assert float(a.wh.min()) >= 0.1 and float(a.wh.max()) < 0.999
    assert float(a.oy.max()) < cfg.expand_ratio - 1.0 and float(a.oy.min()) >= 0.0
    assert set(a.min_iou.tolist()) <= set(np.float32(cfg.min_ious).tolist())
    assert 0 < int((a.expand < 0.5).sum()) < 64


def test_train_augment_one_image_and_variants():
    images, boxes, labels, valid = (torch.as_tensor(a) for a in make_batch(5, batch=1))
    cfg = port_pre.PreprocessConfig(out_shape=(40, 32))
    img, b, lab, v = port_pre.train_augment(torch.Generator().manual_seed(0), images[0], boxes[0], labels[0],
                                            valid[0], cfg)
    assert img.shape == (40, 32, 3) and b.shape == (6, 4) and v.dtype == torch.bool
    back = port_pre.unwhiten(img)  # a bilinear blend of [0, 1] pixels and the mean
    assert float(back.min()) >= -1e-5 and float(back.max()) <= 1.0 + 1e-5
    # the SSD chain on the same image: its own draws, the colour distortion on by default
    cfg = port_pre.PreprocessConfig(out_shape=(40, 32), variant="ssd")
    draws = port_pre.draw_augment(torch.Generator().manual_seed(0), 1, cfg)
    assert isinstance(draws, port_pre.SsdAugmentDraws) and draws.color is not None
    img, b, lab, v = port_pre.train_augment(torch.Generator().manual_seed(0), images[0], boxes[0], labels[0],
                                            valid[0], cfg)
    assert img.shape == (40, 32, 3) and b.shape == (6, 4) and v.dtype == torch.bool
    back = port_pre.unwhiten(img)  # clipped to [0, 1] after the distortion
    assert float(back.min()) >= -1e-5 and float(back.max()) <= 1.0 + 1e-5
    assert bool((v <= valid[0]).all()) and bool(v.any())
