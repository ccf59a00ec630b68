"""The port's zoo networks whole (`models/zoo.py`: Inception-V3, Xception,
Inception-ResNet-V2) and the VGG classifiers (`models/vgg.py`:
`VGGBackbone`, `VGG16Classifier`) against the JAX package's on the CPU,
with the same numpy-made weights, BatchNorm statistics and images; and
JAX's `init` of each network loaded into the port's.

Tolerances, as `test_torch_zoo.py`: float32 within 1e-4 of each output's
largest magnitude and of each BatchNorm statistic's largest update, bf16
within 5e-2. Train mode is held to JAX's where a train-mode BatchNorm normalizes
over enough values: at 75x75 Inception-V3's last maps are 1x1, two values a
channel at batch 2, and there even JAX's own float32 forward lies 68% of
its largest magnitude from a float64 forward of the same network; so the
fast tier runs train mode for Xception at 75x75 (its last maps 3x3) and
Inception-ResNet-V2 at 139x139 (3x3), and Inception-V3's train mode is in
the `slow` test at 299x299, where its statistics' updates meet JAX's within
1e-4 and its outputs, whose train-mode roundoff stays at a few 1e-4 of the
largest magnitude in both packages, are held to a float64 forward: the
port's float32 within 1.5 times JAX's float32 distance from it, and JAX's
within 1e-3 of it.

`-m slow` also runs the three networks at their published depth and
299x299 in float32.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.models import vgg as jvgg
from ron_tensorflow_tpu.models import zoo as jzoo
from ron_tensorflow_tpu.train.checkpoint import flatten_params

from ron_tensorflow_tpu_torch.models import vgg, zoo
from ron_tensorflow_tpu_torch.weights import from_jax_params, jax_names

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_zoo import BF16_TOL, DTYPES, F32_TOL, check_stats, close, load_both, nchw, nhwc  # noqa: E402

F64_DISTANCE_RATIO = 1.5
F64_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NETWORKS = {
    # port module, JAX module; 75x75: Xception's pools see 35 (odd) and 18 (even) sides
    "xception_1": (lambda d: zoo.Xception(10, middle_blocks=1, dtype=d),
                   lambda d, t: jzoo.Xception(10, middle_blocks=1, train=t, dtype=d)),
    "inception_resnet_v2_1_1_1": (lambda d: zoo.InceptionResnetV2(10, 1, 1, 1, dtype=d),
                                  lambda d, t: jzoo.InceptionResnetV2(10, 1, 1, 1, train=t, dtype=d)),
    "inception_v3": (lambda d: zoo.InceptionV3(10, dtype=d), lambda d, t: jzoo.InceptionV3(10, train=t, dtype=d)),
    "inception_v3_full": (lambda d: zoo.InceptionV3(dtype=d), lambda d, t: jzoo.InceptionV3(train=t, dtype=d)),
    "xception_full": (lambda d: zoo.Xception(dtype=d), lambda d, t: jzoo.Xception(train=t, dtype=d)),
    "inception_resnet_v2_full": (lambda d: zoo.InceptionResnetV2(dtype=d),
                                 lambda d, t: jzoo.InceptionResnetV2(train=t, dtype=d)),
}


def run_network(name, dt, train, side, batch=2):
    """(port module, input, its outputs, JAX's outputs, (the statistics
    before, JAX's updated variables))."""
    make, jmake = NETWORKS[name]
    tdt, jdt = DTYPES[dt]
    x = np.random.default_rng(1).normal(0, 1, (batch, side, side, 3)).astype(np.float32)
    m, jm = make(tdt), jmake(jdt, train)
    jv, stats = load_both(m, jm, x, seed=3)
    with jax.default_matmul_precision("highest"):
        if train:
            (ref, ref_eps), new_vars = jax.jit(lambda v, a: jm.apply(v, a, mutable=["batch_stats"]))(jv, jnp.asarray(x))
        else:
            (ref, ref_eps), new_vars = jax.jit(jm.apply)(jv, jnp.asarray(x)), None
    with torch.no_grad():
        got, eps = m(torch.as_tensor(x), train=train)
    assert got.dtype == torch.float32 and got.shape == ref.shape and eps.keys() == ref_eps.keys()
    assert all(e.dtype == tdt for e in eps.values())
    return m, x, (got, eps), (ref, ref_eps), (stats, new_vars)


def check_outputs(name, got, ref, tol):
    close(got[0], ref[0], tol, f"{name} logits")
    for k in ref[1]:
        close(got[1][k], ref[1][k], tol, f"{name} {k}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["xception_1", "inception_resnet_v2_1_1_1", "inception_v3"])
def test_network_eval_matches_jax(name, dt):
    _, _, got, ref, _ = run_network(name, dt, False, 75)
    check_outputs(name, got, ref, F32_TOL if dt == "f32" else BF16_TOL)


@pytest.mark.parametrize("name,side", [("xception_1", 75), ("inception_resnet_v2_1_1_1", 139)])
def test_network_train_matches_jax(name, side):
    m, _, got, ref, (stats, new_vars) = run_network(name, "f32", True, side)
    check_outputs(name, got, ref, F32_TOL)
    check_stats(m, stats, new_vars["batch_stats"], F32_TOL, name)


def distance(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.slow
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["inception_v3_full", "xception_full", "inception_resnet_v2_full"])
def test_full_network_matches_jax_at_299(name, train):
    m, x, got, ref, (stats, new_vars) = run_network(name, "f32", train, 299)
    if not train:
        check_outputs(name, got, ref, F32_TOL)
        return
    check_stats(m, stats, new_vars["batch_stats"], F32_TOL, name)
    m64 = NETWORKS[name][0](torch.float64)
    m64.load_state_dict(m.state_dict())
    with torch.no_grad():
        want = m64(torch.as_tensor(x, dtype=torch.float64), train=True)
    for k, g, r, w in [("logits", got[0], ref[0], want[0])] + [(k, got[1][k], ref[1][k], want[1][k]) for k in ref[1]]:
        d_jax, d_port = distance(r, w), distance(g.double(), w)
        assert d_jax <= F64_TOL, (k, d_jax)
        assert d_port <= F64_DISTANCE_RATIO * d_jax + 1e-6, (k, d_port, d_jax)


# --------------------------------------------------------------------------
# the VGG classifiers
# --------------------------------------------------------------------------


# the fc head is the same code at every depth: heavy at vgg_16 in the fast tier, every pair under -m slow
VGG_CASES = [("vgg_a", "reduced"), ("vgg_16", "reduced"), ("vgg_19", "reduced"), ("vgg_16", "heavy"),
             pytest.param("vgg_a", "heavy", marks=pytest.mark.slow),
             pytest.param("vgg_19", "heavy", marks=pytest.mark.slow)]


@pytest.mark.parametrize("depth,fc_variant", VGG_CASES)
def test_vgg_backbone_matches_jax(depth, fc_variant):
    m = vgg.VGGBackbone(depth, fc_variant)
    jm = jvgg.VGGBackbone(depth=depth, fc_variant=fc_variant)
    x = np.random.default_rng(2).normal(0, 50, (1, 32, 32, 3)).astype(np.float32)
    jv, _ = load_both(m, jm, x, seed=5)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jm.apply)(jv, jnp.asarray(x))
    with torch.no_grad():
        got = m(nchw(x))
    assert got.keys() == ref.keys() == {f"block{i}" for i in range(1, 8)}
    for k in ref:
        close(nhwc(got[k]), ref[k], F32_TOL, f"{depth} {fc_variant} {k}")


def test_vgg_backbone_rejects_unknown_names():
    with pytest.raises(ValueError, match="depth"):
        vgg.VGGBackbone("vgg_13")
    with pytest.raises(ValueError, match="variant"):
        vgg.VGGBackbone("vgg_16", "huge")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_vgg16_classifier_matches_jax(dt):
    tdt, jdt = DTYPES[dt]
    m = vgg.VGG16Classifier(num_classes=12, dtype=tdt)
    jm = jvgg.VGG16Classifier(num_classes=12, dtype=jdt)
    x = np.random.default_rng(4).normal(0, 50, (2, 40, 40, 3)).astype(np.float32)
    jv, _ = load_both(m, jm, x, seed=6)
    with jax.default_matmul_precision("highest"):
        ref, ref_eps = jax.jit(jm.apply)(jv, jnp.asarray(x))
    with torch.no_grad():
        got, eps = m(torch.as_tensor(x))
    tol = F32_TOL if dt == "f32" else BF16_TOL
    assert got.dtype == tdt and np.asarray(ref).dtype == jdt  # JAX's classifier does not cast its logits
    close(got, ref, tol, "logits")
    assert eps.keys() == ref_eps.keys() == {f"block{i}" for i in range(1, 8)}
    for k in ref_eps:
        close(eps[k], ref_eps[k], tol, k)


# --------------------------------------------------------------------------
# JAX's init loads into the port's networks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["inception_v3", "xception", "inception_resnet_v2", "vgg16_classifier"])
def test_from_jax_params_loads_jax_init(name):
    """The variables of the JAX network's `init` at its published depth load
    into the port's with no missing or extra key (strict), and come back
    out under the same names (`jax_names`). The tree is `init`'s, through
    `jax.eval_shape` (the values are the loader's to carry, not JAX's to
    draw here)."""
    port, jmodel, side = {
        "inception_v3": (zoo.InceptionV3, jzoo.InceptionV3(), 75),
        "xception": (zoo.Xception, jzoo.Xception(), 75),
        "inception_resnet_v2": (zoo.InceptionResnetV2, jzoo.InceptionResnetV2(), 75),
        "vgg16_classifier": (vgg.VGG16Classifier, jvgg.VGG16Classifier(), 32),
    }[name]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)))
    rng = np.random.default_rng(0)
    params = {k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in flatten_params(shapes["params"]).items()}
    stats = {k: rng.normal(0, 1, v.shape).astype(np.float32)
             for k, v in flatten_params(shapes.get("batch_stats", {})).items()}
    m = port()
    m.load_state_dict(from_jax_params(params, stats), strict=True)
    names = jax_names(m)
    assert sorted(names.values()) == sorted([*params, *stats])
    tensors = {names[n]: t for n, t in [*m.named_parameters(), *m.named_buffers()]}
    kernel = params["logits/kernel"]
    assert kernel.ndim == 2 and np.array_equal(tensors["logits/kernel"].detach().numpy().T, kernel)
    k4 = next(k for k in params if k.endswith("/kernel") and params[k].ndim == 4)
    assert np.array_equal(tensors[k4].detach().permute(2, 3, 1, 0).numpy(), params[k4])
