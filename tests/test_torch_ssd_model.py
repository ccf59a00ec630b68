"""The port's SSD-300/512 and its layers against the JAX package's, on the
CPU, with the same numpy-made weights and images on both sides.

Tolerances: both sides compute in float32 on the CPU (JAX under
`default_matmul_precision("highest")`), so they differ by summation order
only: single layers within 1e-5 relative; the whole SSD (15 VGG convs, the
extra blocks and the heads) within 1e-4 of each output's largest magnitude
(measured ~4e-6). The bf16 SSD-300 is held as `test_torch_bf16_parity.py`
holds the bf16 RON: within 5e-2 of each output's largest magnitude of JAX's
bf16 output, and no further from the f32 reference than 1.5 times JAX's
bf16 (both round at other places in another order).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.inference.detector import DetectionConfig as JaxDetectionConfig
from ron_tensorflow_tpu.inference.detector import Detector as JaxDetector
from ron_tensorflow_tpu.models import layers as jax_layers
from ron_tensorflow_tpu.models import ssd as jax_ssd
from ron_tensorflow_tpu.train.checkpoint import flatten_params, unflatten_params

from ron_tensorflow_tpu.presets import EVAL_PRESETS

from ron_tensorflow_tpu_torch import kernels
from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, Detector
from ron_tensorflow_tpu_torch.kernels.nms import MAX_K
from ron_tensorflow_tpu_torch.models import get_network, layers
from ron_tensorflow_tpu_torch.models import ssd as port_ssd
from ron_tensorflow_tpu_torch.models.spec import SSD_300_SPEC, SSD_512_SPEC
from ron_tensorflow_tpu_torch.models.testing import scale_ssd_heads, seeded_flax_params
from ron_tensorflow_tpu_torch.weights import from_jax_params, to_jax_params

F32_TOL = 1e-4  # of each output's largest magnitude, the whole model
LAYER_TOL = 1e-5
BF16_REL_TOL = 5e-2
F32_DISTANCE_RATIO = 1.5
SPECS = {"ssd_300_vgg": jax_ssd.SSD_300_SPEC, "ssd_512_vgg": jax_ssd.SSD_512_SPEC}
PORT_SPECS = {"ssd_300_vgg": SSD_300_SPEC, "ssd_512_vgg": SSD_512_SPEC}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: its CPU forwards share the
    cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.as_tensor(np.asarray(a, np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def jax_variables(params, stats=None):
    out = {"params": jax.tree.map(jnp.asarray, unflatten_params(params))}
    if stats:
        out["batch_stats"] = jax.tree.map(jnp.asarray, unflatten_params(stats))
    return out


def whitened_images(seed, n, hw):
    return (np.random.default_rng(seed).uniform(0, 255, (n, *hw, 3)) - 120).astype(np.float32)


@pytest.fixture(scope="module")
def ssd300():
    """SSD-300 with He-scaled seeded weights, its heads scaled to a logit std
    of 2.5 on the image (class probabilities far from flat), as
    `chip_smoke.py` makes them."""
    model, spec = get_network("ssd_300_vgg")
    params, _ = seeded_flax_params(model, seed=300, gain=2.0 ** 0.5)
    model.load_state_dict(from_jax_params(params, {}), strict=True)
    images = whitened_images(1, 1, spec.img_shape)
    with torch.no_grad():
        scale_ssd_heads(model, torch.as_tensor(images))
    params = to_jax_params(model, model.named_parameters())
    with jax.default_matmul_precision("highest"):
        ref32 = jax_ssd.SSD(spec=SPECS["ssd_300_vgg"]).apply(jax_variables(params), jnp.asarray(images))
    return params, model, images, [np.asarray(r) for r in ref32]


# --------------------------------------------------------------------------- #
# layers


@pytest.mark.parametrize("case", ["valid 3x3", "valid strided after pad", "valid 4x4 after pad"])
def test_valid_conv_matches_flax(case):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 6, 5)).astype(np.float32)
    kernel, strides = ((4, 4), (1, 1)) if "4x4" in case else ((3, 3), (2, 2) if "strided" in case else (1, 1))
    xin = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0))) if "pad" in case else x
    jconv = jax_layers.Conv(3, kernel, strides=strides, padding="VALID")
    variables = jconv.init(jax.random.PRNGKey(0), xin)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jconv.apply(variables, xin))
    conv = layers.Conv(5, 3, kernel=kernel, strides=strides, padding="VALID")
    conv.load_state_dict(from_jax_params({k: np.asarray(v) for k, v in flatten_params(variables["params"]).items()},
                                         {}))
    t = nchw(x)
    got = nhwc(conv(layers.pad2d(t, (1, 1)) if "pad" in case else t))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=LAYER_TOL, atol=LAYER_TOL)


def test_conv_rejects_unknown_padding():
    with pytest.raises(ValueError, match="padding"):
        layers.Conv(3, 4, padding="CAUSAL")


@pytest.mark.parametrize("hw", [(19, 19), (6, 5)])
def test_pool_3x3_stride_1_matches_flax_same(hw):
    """Negative inputs: the SAME pad must not take part (flax pads with -inf)."""
    x = -np.random.default_rng(1).uniform(0.5, 3.0, (2, *hw, 4)).astype(np.float32)
    ref = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(1, 1), padding="SAME"))
    got = nhwc(layers.max_pool_3x3_s1(nchw(x)))
    assert got.shape == ref.shape and (got < 0).all()
    np.testing.assert_array_equal(got, ref)


def test_dropout_follows_flax_semantics():
    x = torch.rand(64, 32, 8, 8, generator=torch.Generator().manual_seed(0)) + 0.5
    drop = layers.Dropout(0.5)
    assert drop(x) is x and layers.Dropout(0.0)(x, train=True) is x
    y = drop(x, train=True, generator=torch.Generator().manual_seed(1))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] * 2.0, rtol=0, atol=0)
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    again = drop(x, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(y, again)  # the mask is the generator's
    assert not bool(layers.Dropout(1.0)(x, train=True).any())
    bf = drop(x.to(torch.bfloat16), train=True, generator=torch.Generator().manual_seed(1))
    assert bf.dtype == torch.bfloat16 and torch.equal(bf != 0, kept)


@pytest.mark.parametrize("strided", [True, False])
def test_extra_block_matches_flax(strided):
    x = np.random.default_rng(2).normal(size=(2, 5, 5, 8)).astype(np.float32)
    jblock = jax_ssd.SSDExtraBlock(4, 6, strided=strided)
    variables = jblock.init(jax.random.PRNGKey(0), x)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jblock.apply(variables, x))
    block = port_ssd.SSDExtraBlock(8, 4, 6, strided=strided)
    block.load_state_dict(from_jax_params({k: np.asarray(v) for k, v in flatten_params(variables["params"]).items()},
                                          {}), strict=True)
    got = nhwc(block(nchw(x)))
    assert got.shape == ref.shape == (2, 3, 3, 6)
    np.testing.assert_allclose(got, ref, rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("normalization", [20.0, -1.0])
def test_multibox_head_matches_flax(normalization):
    x = np.random.default_rng(3).normal(size=(2, 4, 3, 8)).astype(np.float32)
    jhead = jax_ssd.MultiboxHead(num_anchors=6, num_classes=5, normalization=normalization)
    variables = jhead.init(jax.random.PRNGKey(0), x)
    p = {k: np.asarray(v) for k, v in flatten_params(variables["params"]).items()}
    if normalization > 0:
        p["l2_norm/gamma"] = np.random.default_rng(4).uniform(10, 30, 8).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref_cls, ref_loc = jhead.apply(jax_variables(p), x)
    head = port_ssd.MultiboxHead(8, 6, 5, normalization)
    head.load_state_dict(from_jax_params(p, {}), strict=True)
    cls, loc = head(nchw(x))
    np.testing.assert_allclose(cls.detach().numpy(), np.asarray(ref_cls).reshape(2, -1, 5), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    np.testing.assert_allclose(loc.detach().numpy(), np.asarray(ref_loc).reshape(2, -1, 4), rtol=LAYER_TOL,
                               atol=LAYER_TOL)


# --------------------------------------------------------------------------- #
# the whole model


def test_ssd_specs_and_anchor_counts_match_jax():
    for name, jspec in SPECS.items():
        spec = PORT_SPECS[name]
        assert get_network(name)[1] is spec and get_network(name + "_caffe")[1] is spec
        for field in ("name", "img_shape", "num_classes", "feat_layers", "feat_shapes", "allowed_borders",
                      "anchor_sizes", "anchor_ratios", "anchor_steps", "anchor_offset", "prior_scaling",
                      "anchor_style", "normalizations", "has_objectness"):
            assert getattr(spec, field) == getattr(jspec, field), (name, field)
        got, ref = spec.anchor_layout(), jspec.anchor_layout()
        assert got.num_anchors == ref.num_anchors
        np.testing.assert_array_equal(np.asarray(got.cyxhw), np.asarray(ref.cyxhw))
    assert PORT_SPECS["ssd_300_vgg"].anchor_layout().num_anchors == 8732
    assert PORT_SPECS["ssd_512_vgg"].anchor_layout().num_anchors == 24564


def test_parameter_tree_round_trips_with_flax():
    """The port's tensors carry exactly the flax tree's names and shapes
    (jax.eval_shape of SSD.init), gamma included, both ways."""
    for name, jspec in SPECS.items():
        shapes = jax.eval_shape(lambda jspec=jspec: jax_ssd.SSD(spec=jspec).init(
            jax.random.PRNGKey(0), jnp.zeros((1, *jspec.img_shape, 3)), train=False))
        flat = {k: v.shape for k, v in flatten_params(shapes["params"]).items()}
        model, _ = get_network(name)
        params, stats = seeded_flax_params(model, seed=7)
        assert not stats and {k: v.shape for k, v in params.items()} == flat
        assert "block4_box/l2_norm/gamma" in flat and ("block12_conv4x4/conv/kernel" in flat) == (name == "ssd_512_vgg")
        model.load_state_dict(from_jax_params(params, {}), strict=True)
        back = to_jax_params(model, model.named_parameters())
        assert back.keys() == params.keys()
        for k, v in params.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["ssd_300_vgg", "ssd_512_vgg"])
def test_ssd_f32_forward_matches_jax(name, ssd300):
    if name == "ssd_300_vgg":
        params, model, images, ref = ssd300
    else:
        model, spec = get_network(name)
        params, _ = seeded_flax_params(model, seed=512)
        model.load_state_dict(from_jax_params(params, {}), strict=True)
        images = whitened_images(2, 1, spec.img_shape)
        with jax.default_matmul_precision("highest"):
            ref = jax_ssd.SSD(spec=SPECS[name]).apply(jax_variables(params), jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.as_tensor(images))
    n = SPECS[name].anchor_layout().num_anchors
    assert got.logits.shape == (1, n, 21) and got.locations.shape == (1, n, 4)
    for field, r, g in zip(got._fields, ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32, field
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=F32_TOL * float(np.abs(r).max()), err_msg=field)
    np.testing.assert_array_equal(got.objness_pred.numpy(), 1.0)
    np.testing.assert_array_equal(got.objness_logits.numpy()[..., 1], 1e3)
    if name == "ssd_300_vgg":  # the heads scaled: the softmax is far from flat, the test sees the class order
        assert float(got.predictions.max(-1).values.mean()) > 3.0 / 21


def test_ssd_train_mode_dropout(ssd300):
    """train=True drops after conv6 and conv7 (the generator's masks); at
    rate 0 it is the eval forward."""
    params, _, images, _ = ssd300
    x = torch.as_tensor(images)
    zero, _ = get_network("ssd_300_vgg", dropout_rate=0.0)
    zero.load_state_dict(from_jax_params(params, {}), strict=True)
    with torch.no_grad():
        ref = zero(x)
        same = zero(x, train=True, generator=torch.Generator().manual_seed(0))
        half, _ = get_network("ssd_300_vgg")
        half.load_state_dict(from_jax_params(params, {}), strict=True)
        a = half(x, train=True, generator=torch.Generator().manual_seed(0))
        b = half(x, train=True, generator=torch.Generator().manual_seed(0))
        c = half(x, train=True, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(u, v) for u, v in zip(ref, same))
    assert torch.equal(a.logits, b.logits) and not torch.equal(a.logits, c.logits)
    # block4's head reads nothing after the dropouts; block7's reads conv7 before its dropout
    n4 = 38 * 38 * 4
    assert torch.equal(a.logits[:, :n4], ref.logits[:, :n4])
    assert not torch.equal(a.logits[:, n4:], ref.logits[:, n4:])


def test_ssd300_bf16_matches_jax_bf16(ssd300):
    params, _, images, ref32 = ssd300
    ref = jax_ssd.SSD(spec=SPECS["ssd_300_vgg"], dtype=jnp.bfloat16).apply(jax_variables(params),
                                                                          jnp.asarray(images))
    model, _ = get_network("ssd_300_vgg", dtype=torch.bfloat16)
    model.load_state_dict(from_jax_params(params, {}), strict=True)
    with torch.inference_mode():
        got = model(torch.as_tensor(images))
    for name, r, g, r32 in zip(ref._fields, ref, got, ref32):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32, name
        g = g.numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=BF16_REL_TOL * float(np.abs(r).max()), err_msg=name)
        port_drift, jax_drift = np.abs(g - r32).max(), np.abs(r - r32).max()
        assert port_drift <= F32_DISTANCE_RATIO * jax_drift, (name, port_drift, jax_drift)


def test_ssd300_fused_block1_on_cpu_runs_the_plain_version(ssd300):
    """fuse_block1 at 300x300 (K-B's ragged tiles on the card): on the CPU the
    plain version, nothing launched, the same outputs as the bf16 model with
    block 1 unfused up to bf16 rounding (as test_torch_bf16_parity.py holds RON)."""
    params, _, images, ref32 = ssd300
    outs = {}
    for fuse in (False, True):
        model, _ = get_network("ssd_300_vgg", dtype=torch.bfloat16, fuse_block1=fuse)
        model.load_state_dict(from_jax_params(params, {}), strict=True)
        kernels.reset_launch_counts()
        with torch.inference_mode():
            outs[fuse] = model(torch.as_tensor(images))
        assert kernels.launch_counts()["fused_vgg_block1"] == 0
    for name, a, b, r32 in zip(outs[True]._fields, outs[True], outs[False], ref32):
        np.testing.assert_allclose(a.numpy(), r32, rtol=0, atol=BF16_REL_TOL * float(np.abs(r32).max()), err_msg=name)
        assert np.abs(a.numpy() - r32).max() <= F32_DISTANCE_RATIO * max(np.abs(b.numpy() - r32).max(), 1e-30), name


def test_ssd300_detector_with_the_eval_preset_matches_jax(ssd300):
    """The ssd_300 eval preset's detection values (select 0.01, objectness
    0, top-k 400 of 8 732 anchors, keep 200, 'min' NMS 0.45) pass through
    DetectionConfig unchanged, fit K-A (K <= MAX_K), and the port's CPU
    Detector (plain K-A) gives JAX's detections: equal keep counts, scores
    and boxes within 1e-5, each row compared as a set (candidates whose
    scores lie within float32 roundoff may come in either order on the two
    sides)."""
    params, model, images, _ = ssd300
    preset = EVAL_PRESETS["ssd_300"]
    kw = dict(select_threshold=preset.select_threshold, objectness_threshold=preset.objectness_threshold,
              top_k=preset.select_top_k, keep_top_k=preset.keep_top_k, nms_threshold=preset.nms_threshold)
    assert kw == dict(select_threshold=0.01, objectness_threshold=0.0, top_k=400, keep_top_k=200, nms_threshold=0.45)
    cfg = DetectionConfig(**kw)
    assert all(getattr(cfg, k) == v for k, v in kw.items()) and cfg.nms_mode == "min" and cfg.top_k <= MAX_K
    with jax.default_matmul_precision("highest"):
        ref = [np.asarray(a) for a in JaxDetector(jax_ssd.SSD(spec=SPECS["ssd_300_vgg"]), SPECS["ssd_300_vgg"],
                                                  JaxDetectionConfig(**kw))(jax_variables(params), jnp.asarray(images))]
    got = [t.numpy() for t in Detector(model, PORT_SPECS["ssd_300_vgg"], cfg, device="cpu")(torch.as_tensor(images))]
    counts = (ref[0] > 0).sum(-1)
    np.testing.assert_array_equal((got[0] > 0).sum(-1), counts)
    assert counts.sum() > 100
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5)
    for (i, c), n in np.ndenumerate(counts):
        g, r = got[1][i, c, :n], ref[1][i, c, :n]
        np.testing.assert_allclose(g[np.lexsort(g.T)], r[np.lexsort(r.T)], rtol=0, atol=1e-5)
