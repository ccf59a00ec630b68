"""The PyTorch port's layers, RON model and Detector against the JAX package,
on the CPU, with the same numpy-made inputs and weights on both sides.

Tolerances: both sides compute in float32 on the CPU (JAX under
`default_matmul_precision("highest")`), so they differ only by summation
order, a few ulps per layer: 1e-5 relative on single layers, 1e-4 on the
13-conv backbone + heads, and 1e-5 absolute on detection scores and boxes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.inference.detector import DetectionConfig as JaxDetectionConfig
from ron_tensorflow_tpu.inference.detector import Detector as JaxDetector
from ron_tensorflow_tpu.models import layers as jax_layers
from ron_tensorflow_tpu.models.ron import RON as JaxRON
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.train.checkpoint import flatten_params, unflatten_params

from ron_tensorflow_tpu_torch.data.preprocess import whiten
from ron_tensorflow_tpu_torch.data.resize import tf1_bilinear_resize
from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, Detector
from ron_tensorflow_tpu_torch.models import layers
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC, RON_TINY_SPEC
from ron_tensorflow_tpu_torch.weights import from_jax_params, load_trained_fixture

TRAINED_FIXTURE = "tests/fixtures/e2e_parity_trained.npz"


def nchw(a):
    return torch.as_tensor(np.asarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------------------- #
# layers


def test_conv_bn_relu_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 7, 5)).astype(np.float32)
    jconv = jax_layers.Conv(6, (3, 3), dilation=(2, 2), norm=True)
    variables = jconv.init(jax.random.PRNGKey(0), x)
    p = {k: np.asarray(v) for k, v in flatten_params(variables["params"]).items()}
    s = {
        "bn/mean": rng.normal(size=6).astype(np.float32),
        "bn/var": rng.uniform(0.5, 1.5, 6).astype(np.float32),
    }
    p["bn/scale"] = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    p["bn/bias"] = rng.normal(size=6).astype(np.float32)
    variables = {
        "params": {"conv": {"kernel": p["conv/kernel"]}, "bn": {"scale": p["bn/scale"], "bias": p["bn/bias"]}},
        "batch_stats": {"bn": {"mean": s["bn/mean"], "var": s["bn/var"]}},
    }
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jconv.apply(variables, x))
    conv = layers.Conv(5, 6, dilation=(2, 2), norm=True)
    conv.load_state_dict(from_jax_params(p, s))
    got = nhwc(conv(nchw(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(4, 4), (5, 3)])
def test_strided_2x2_conv_same_padding(hw):
    """The first reverse connection's 2x2/s2 SAME conv, also on odd maps
    (SAME then pads only the end)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, *hw, 4)).astype(np.float32)
    jconv = jax_layers.Conv(3, (2, 2), strides=(2, 2))
    variables = jconv.init(jax.random.PRNGKey(1), x)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jconv.apply(variables, x))
    conv = layers.Conv(4, 3, kernel=(2, 2), strides=(2, 2))
    conv.load_state_dict(from_jax_params(flatten_params(variables["params"]), {}))
    np.testing.assert_allclose(nhwc(conv(nchw(x))), ref, rtol=1e-5, atol=1e-5)


def test_conv_transpose_tap_flip():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    jdeconv = jax_layers.ConvTranspose(6)
    variables = jdeconv.init(jax.random.PRNGKey(2), x)
    params = {k: np.asarray(v) for k, v in flatten_params(variables["params"]).items()}
    params["deconv_bias"] = rng.normal(size=6).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jdeconv.apply({"params": params}, x))
    deconv = layers.ConvTranspose(5, 6)
    deconv.load_state_dict(from_jax_params(params, {}))
    np.testing.assert_allclose(nhwc(deconv(nchw(x))), ref, rtol=1e-5, atol=1e-5)


def test_pool_l2norm_pad_match_flax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        nhwc(layers.max_pool_2x2(nchw(x))), np.asarray(jax_layers.max_pool_2x2(x))
    )
    np.testing.assert_array_equal(
        nhwc(layers.pad2d(nchw(x), (1, 2))), np.asarray(jax_layers.pad2d(x, (1, 2)))
    )
    jl2 = jax_layers.L2Normalization(scale_init=20.0)
    ref = np.asarray(jl2.apply(jl2.init(jax.random.PRNGKey(0), x), x))
    got = nhwc(layers.L2Normalization(4, scale_init=20.0)(nchw(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# tiny RON: weights carried across by weights.py


@pytest.fixture(scope="module")
def tiny():
    """JAX tiny RON with numpy-seeded weights and BN statistics, and the
    port's model loaded from the same numbers."""
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
    model = RON(RON_TINY_SPEC)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    pixels = rng.uniform(0, 255, size=(2, 80, 72, 3)).astype(np.float32)
    return jmodel, jvars, model, pixels


def _whitened(pixels):
    return np.stack([whiten(torch.as_tensor(tf1_bilinear_resize(p, (64, 64)) / 255.0)).numpy() for p in pixels])


def test_tiny_detector_outputs_match_jax(tiny):
    jmodel, jvars, model, pixels = tiny
    images = _whitened(pixels)
    with jax.default_matmul_precision("highest"):
        ref = jmodel.apply(jvars, jnp.asarray(images), train=False)
    with torch.inference_mode():
        got = model(torch.as_tensor(images))
    for name, r, g in zip(ref._fields, ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32, name
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * scale, err_msg=name)


def test_tiny_pixels_to_boxes_match_jax_detector(tiny):
    """Resize + whiten + Detector against the JAX Detector with the Pallas
    fixpoint NMS (interpret mode on the CPU)."""
    jmodel, jvars, model, pixels = tiny
    images = _whitened(pixels)
    jdet = JaxDetector(jmodel, JAX_TINY_SPEC, JaxDetectionConfig(nms_method="pallas"))
    with jax.default_matmul_precision("highest"):
        ref_s, ref_b = (np.asarray(a) for a in jdet(jvars, jnp.asarray(images)))
    det = Detector(model, RON_TINY_SPEC, DetectionConfig(nms_method="pallas"), device="cpu")
    got_s, got_b = (t.numpy() for t in det(images))
    assert got_s.shape == ref_s.shape and got_b.shape == ref_b.shape
    ref_n, got_n = (ref_s > 0).sum(-1), (got_s > 0).sum(-1)
    assert ref_n.sum() > 0
    np.testing.assert_array_equal(got_n, ref_n)  # keep counts per (image, class)
    np.testing.assert_allclose(got_s, ref_s, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_b, ref_b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["loop", "fixpoint"])
def test_tiny_nms_methods_agree(tiny, method):
    """The port's Detector under JAX's plain NMS methods (K-C's plain
    version, which divides) against the JAX Detector's, which divide too;
    and the port's 'pallas' (K-A's plain version, division-free) keeps the
    same sets here."""
    jmodel, jvars, model, pixels = tiny
    images = _whitened(pixels)
    jdet = JaxDetector(jmodel, JAX_TINY_SPEC, JaxDetectionConfig(nms_method=method))
    with jax.default_matmul_precision("highest"):
        ref_s, ref_b = (np.asarray(a) for a in jdet(jvars, jnp.asarray(images)))
    for port_method in (method, "pallas"):
        det = Detector(model, RON_TINY_SPEC, DetectionConfig(nms_method=port_method), device="cpu")
        got_s, got_b = (t.numpy() for t in det(images))
        np.testing.assert_array_equal((got_s > 0).sum(-1), (ref_s > 0).sum(-1))
        np.testing.assert_allclose(got_s, ref_s, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_b, ref_b, rtol=0, atol=1e-5)


def test_entry_point_defaults_to_cuda(tiny):
    """Without a `device`, the Detector asks for CUDA; on a machine without
    a card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Detector(tiny[2], RON_TINY_SPEC)


def test_from_jax_params_rejects_unknown_leaf():
    with pytest.raises(KeyError):
        from_jax_params({"backbone/conv1_1/conv/weird": np.zeros(3)}, {})


# --------------------------------------------------------------------------- #
# full RON-320, trained weights (slow)


@pytest.mark.slow
@pytest.mark.parametrize("img", ["1", "2", "3", "4"])
def test_ron320_trained_fixture_streaming_parity(img):
    """The assertions of tests/test_e2e_parity.py:205-238 (streaming path)
    applied to the port: equal keep counts, scores and boxes within 2e-3."""
    if not os.path.exists(TRAINED_FIXTURE):
        pytest.fail(f"{TRAINED_FIXTURE} is missing")
    model = RON(RON_320_SPEC)
    model.load_state_dict(from_jax_params(*load_trained_fixture(TRAINED_FIXTURE)), strict=True)
    fx = np.load(TRAINED_FIXTURE, allow_pickle=False)
    image = whiten(torch.as_tensor(tf1_bilinear_resize(fx[f"img_{img}_pixels"], (320, 320)) / 255.0))
    det = Detector(model, RON_320_SPEC, DetectionConfig(), device="cpu")
    scores, boxes = (t.numpy() for t in det(image[None]))
    for cls in range(1, 21):
        ref_s = fx[f"img_{img}_stream_c{cls}_scores"][0]
        ref_b = fx[f"img_{img}_stream_c{cls}_boxes"][0]
        ref_n = int((ref_s > 0).sum())
        got_n = int((scores[0, cls - 1] > 0).sum())
        assert got_n == ref_n, f"class {cls}: kept {got_n} vs reference {ref_n}"
        np.testing.assert_allclose(scores[0, cls - 1, :ref_n], ref_s[:ref_n], atol=2e-3, rtol=0)
        np.testing.assert_allclose(boxes[0, cls - 1, :ref_n], ref_b[:ref_n], atol=2e-3, rtol=0)
