"""The zoo's weight importers (`models/zoo_import.py`, a copy of the JAX
package's) against the JAX package's, on the same inputs, bit for bit;
their output loaded into the port's networks with no missing or extra key.

Inputs: a torchvision-layout `inception_v3` state_dict
(`models/testing.py::torchvision_inception_v3_state_dict`, held here to
the module names and shapes of `tests/test_zoo.py`'s torchvision replica),
and Keras-style (layer name, weights) lists for Xception and
Inception-ResNet-V2 synthesized with keras.applications' layer names, its
auto-naming counters (`conv2d_7`, `batch_normalization_7`) and shapes, in
an order other than creation order (`model.layers` is topological).

The imported Inception-V3 is held to the torchvision replica's forward on
the same weights within 1e-4 of the logits' largest magnitude (float32,
summation order only). `-m slow` imports `tf.keras.applications` models
(where TensorFlow is installed) and holds the port's forward to Keras's
within the JAX package's `tests/test_zoo.py` tolerance (atol 3e-4, rtol
1e-4).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.models import zoo_import as jax_import
from ron_tensorflow_tpu.train.checkpoint import flatten_params as jax_flatten

from ron_tensorflow_tpu_torch.models import zoo, zoo_import
from ron_tensorflow_tpu_torch.models.testing import torchvision_inception_v3_state_dict
from ron_tensorflow_tpu_torch.train.checkpoint import flatten_params
from ron_tensorflow_tpu_torch.weights import from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_zoo import _torch_inception_v3  # noqa: E402  (torchvision's module names, no torchvision needed)

F32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def same_variables(got, want):
    """Two importers' outputs equal bit for bit: the same flax paths, dtypes,
    shapes and values."""
    assert got.keys() == want.keys() == {"params", "batch_stats"}
    for part in got:
        g, w = flatten_params(got[part]), jax_flatten(want[part])
        assert g.keys() == w.keys(), part
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


def load(model, variables):
    model.load_state_dict(from_jax_params(flatten_params(variables["params"]),
                                          flatten_params(variables["batch_stats"])), strict=True)
    return model


# --------------------------------------------------------------------------
# torchvision Inception-V3
# --------------------------------------------------------------------------


def test_torchvision_layout_matches_the_replica():
    replica = {k: tuple(v.shape) for k, v in _torch_inception_v3().state_dict().items()}
    sd = {k: tuple(v.shape) for k, v in torchvision_inception_v3_state_dict(0).items()}
    assert {k: sd[k] for k in replica} == replica
    assert all(k.startswith("AuxLogits.") for k in set(sd) - set(replica)) and len(set(sd) - set(replica)) == 14


def test_inception_v3_from_torch_equals_jax_and_loads():
    sd = torchvision_inception_v3_state_dict(1)
    got = zoo_import.inception_v3_from_torch(sd)
    same_variables(got, jax_import.inception_v3_from_torch(sd))
    # numpy arrays are taken as torch tensors are
    same_variables(zoo_import.inception_v3_from_torch({k: v.numpy() for k, v in sd.items()}), got)
    model = load(zoo.InceptionV3(num_classes=1000), got)

    replica = _torch_inception_v3()
    missing, unexpected = replica.load_state_dict(sd, strict=False)
    assert not missing and all(k.startswith("AuxLogits.") for k in unexpected)
    replica.eval()
    x = np.random.default_rng(2).normal(0, 1, (2, 75, 75, 3)).astype(np.float32)
    with torch.no_grad():
        want = replica(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        logits, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=F32_TOL * float(np.abs(want).max()))


# --------------------------------------------------------------------------
# Keras applications: Xception, Inception-ResNet-V2
# --------------------------------------------------------------------------


class KerasNames:
    """keras's auto-naming: the first layer of a class is `conv2d`, the
    next `conv2d_1`; an explicitly named layer takes no number."""

    def __init__(self):
        self.counts = {}

    def __call__(self, family):
        n = self.counts.get(family, 0)
        self.counts[family] = n + 1
        return family if n == 0 else f"{family}_{n}"


def keras_xception_layers(rng, classes=1000):
    """(name, weights) of keras.applications.Xception's weighted layers, in
    creation order: explicit names, the four residual shortcuts auto-named."""
    out, auto = [], KerasNames()
    w = lambda *s: rng.normal(0, 0.1, s).astype(np.float32)  # noqa: E731
    bn = lambda c: [rng.uniform(0.5, 1.5, c).astype(np.float32), w(c), w(c),  # noqa: E731
                    rng.uniform(0.5, 1.5, c).astype(np.float32)]
    out += [("block1_conv1", [w(3, 3, 3, 32)]), ("block1_conv1_bn", bn(32)),
            ("block1_conv2", [w(3, 3, 32, 64)]), ("block1_conv2_bn", bn(64))]

    def sep(name, cin, cout):
        out.extend([(name, [w(3, 3, cin, 1), w(1, 1, cin, cout)]), (name + "_bn", bn(cout))])

    def shortcut(cin, cout):
        out.extend([(auto("conv2d"), [w(1, 1, cin, cout)]), (auto("batch_normalization"), bn(cout))])

    for blk, cin, cout in ((2, 64, 128), (3, 128, 256), (4, 256, 728)):
        shortcut(cin, cout)
        sep(f"block{blk}_sepconv1", cin, cout)
        sep(f"block{blk}_sepconv2", cout, cout)
    for blk in range(5, 13):
        for j in (1, 2, 3):
            sep(f"block{blk}_sepconv{j}", 728, 728)
    shortcut(728, 1024)
    sep("block13_sepconv1", 728, 728)
    sep("block13_sepconv2", 728, 1024)
    sep("block14_sepconv1", 1024, 1536)
    sep("block14_sepconv2", 1536, 2048)
    out.append(("predictions", [w(2048, classes), w(classes)]))
    return out


def keras_inception_resnet_v2_layers(rng, classes=1000):
    """(name, weights) of keras.applications.InceptionResNetV2's weighted
    layers in creation order: `conv2d_bn` makes an auto-named bias-free
    Conv2D and a scale-free BatchNormalization ([beta, mean, var]); each
    block's projection is `block<kind>_<i>_conv` with a bias; `conv_7b`
    and `conv_7b_bn` are named."""
    out, auto = [], KerasNames()
    w = lambda *s: rng.normal(0, 0.1, s).astype(np.float32)  # noqa: E731

    def conv_bn(cin, cout, k=(1, 1), name=None):
        kh, kw = (k, k) if isinstance(k, int) else k
        out.append((name or auto("conv2d"), [w(kh, kw, cin, cout)]))
        out.append(((name + "_bn") if name else auto("batch_normalization"),
                    [w(cout), w(cout), rng.uniform(0.5, 1.5, cout).astype(np.float32)]))
        return cout

    c = conv_bn(3, 32, 3)
    c = conv_bn(c, 32, 3)
    c = conv_bn(c, 64, 3)
    c = conv_bn(c, 80, 1)
    c = conv_bn(c, 192, 3)
    conv_bn(c, 96)
    conv_bn(conv_bn(c, 48), 64, 5)
    conv_bn(conv_bn(conv_bn(c, 64), 96, 3), 96, 3)
    conv_bn(c, 64)
    c = 320

    def block(kind, idx, chains, c):
        mixed = 0
        for chain in chains:
            cin = c
            for cout, k in chain:
                cin = conv_bn(cin, cout, k)
            mixed += cin
        out.append((f"block{kind}_{idx}_conv", [w(1, 1, mixed, c), w(c)]))

    for i in range(1, 11):
        block(35, i, [[(32, 1)], [(32, 1), (32, 3)], [(32, 1), (48, 3), (64, 3)]], c)
    conv_bn(c, 384, 3)
    conv_bn(conv_bn(conv_bn(c, 256), 256, 3), 384, 3)
    c = 1088
    for i in range(1, 21):
        block(17, i, [[(192, 1)], [(128, 1), (160, (1, 7)), (192, (7, 1))]], c)
    conv_bn(conv_bn(c, 256), 384, 3)
    conv_bn(conv_bn(c, 256), 288, 3)
    conv_bn(conv_bn(conv_bn(c, 256), 288, 3), 320, 3)
    c = 2080
    for i in range(1, 11):
        block(8, i, [[(192, 1)], [(192, 1), (224, (1, 3)), (256, (3, 1))]], c)
    conv_bn(c, 1536, 1, name="conv_7b")
    out.append(("predictions", [w(1536, classes), w(classes)]))
    return out


def topological(layers, seed):
    """`model.layers` is not creation order: a fixed shuffle of the list."""
    order = np.random.default_rng(seed).permutation(len(layers))
    return [layers[i] for i in order]


def test_keras_names_follow_keras():
    names = [n for n, _ in keras_inception_resnet_v2_layers(np.random.default_rng(0), 10)]
    assert names[:4] == ["conv2d", "batch_normalization", "conv2d_1", "batch_normalization_1"]
    assert names.count("block8_10_conv") == 1 and "conv_7b_bn" in names and names[-1] == "predictions"
    assert sum(n.startswith("conv2d") for n in names) == 203  # conv_7b is named
    xnames = [n for n, _ in keras_xception_layers(np.random.default_rng(0), 10)]
    assert [n for n in xnames if n.startswith("conv2d")] == ["conv2d", "conv2d_1", "conv2d_2", "conv2d_3"]


def test_xception_from_keras_equals_jax_and_loads():
    layers = keras_xception_layers(np.random.default_rng(3))
    got = zoo_import.xception_from_keras(layers)
    same_variables(got, jax_import.xception_from_keras(layers))
    model = load(zoo.Xception(num_classes=1000), got)
    dw = layers[[n for n, _ in layers].index("block2_sepconv1")][1][0]  # keras [3, 3, C, 1]
    np.testing.assert_array_equal(model.entry_block1.sep1.depthwise.weight.detach().numpy()[:, 0],
                                  dw[..., 0].transpose(2, 0, 1))


def test_inception_resnet_v2_from_keras_equals_jax_and_loads():
    layers = topological(keras_inception_resnet_v2_layers(np.random.default_rng(4)), seed=5)
    got = zoo_import.inception_resnet_v2_from_keras(layers)
    same_variables(got, jax_import.inception_resnet_v2_from_keras(layers))
    model = load(zoo.InceptionResnetV2(num_classes=1000), got)
    final = dict(layers)["block8_10_conv"]
    np.testing.assert_array_equal(model.block8_final.up.bias.detach().numpy(), final[1])
    assert float(model.stem1.conv.bn.weight.detach().min()) == 1.0  # scale-free BN: gamma ones


# --------------------------------------------------------------------------
# -m slow: tf.keras.applications models
# --------------------------------------------------------------------------


def keras_model_layers(model):
    return [(layer.name, layer.get_weights()) for layer in model.layers if layer.get_weights()]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["Xception", "InceptionResNetV2"])
def test_keras_applications_import_matches_keras_forward(name):
    tf = pytest.importorskip("tensorflow")
    tf.random.set_seed(0)
    km = getattr(tf.keras.applications, name)(weights=None, classifier_activation=None)
    rng = np.random.default_rng(0)
    for layer in km.layers:  # fresh statistics are mean 0 / variance 1, which hides a swap
        if type(layer).__name__ == "BatchNormalization":
            w = layer.get_weights()
            w[-2] = rng.normal(0.0, 0.5, w[-2].shape).astype(np.float32)
            w[-1] = rng.uniform(0.5, 1.5, w[-1].shape).astype(np.float32)
            layer.set_weights(w)
    layers = keras_model_layers(km)
    importer = {"Xception": "xception_from_keras", "InceptionResNetV2": "inception_resnet_v2_from_keras"}[name]
    got = getattr(zoo_import, importer)(layers)
    same_variables(got, getattr(jax_import, importer)(layers))
    model = load(zoo.Xception(num_classes=1000) if name == "Xception" else zoo.InceptionResnetV2(num_classes=1000),
                 got)
    x = np.random.default_rng(1).normal(0, 1, (1, 299, 299, 3)).astype(np.float32)
    want = km(tf.constant(x), training=False).numpy()
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), want, atol=3e-4, rtol=1e-4)
