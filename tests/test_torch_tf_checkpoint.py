"""The port's TF checkpoint reader and slim mappings against TensorFlow and
the JAX package's; the port's RON-320 on the reference's own weights
against the TF1 reference graph's outputs (tests/fixtures/
reference_forward.npz, written by tools/reference_forward.py)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.train import tf_checkpoint as jax_tf

from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC
from ron_tensorflow_tpu_torch.train.tf_checkpoint import TFCheckpointReader, slim_ron_to_flat, slim_vgg_to_flat
from ron_tensorflow_tpu_torch.weights import from_jax_params

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from reference_forward import weight_for  # noqa: E402

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

FIXTURE = REPO / "tests" / "fixtures" / "reference_forward.npz"
# VGG-16's convs, and the reduced fc6/fc7 of `vgg16_reducedfc` (RON-320's)
VGG16 = {"conv1": (3, 64, 2), "conv2": (64, 128, 2), "conv3": (128, 256, 3), "conv4": (256, 512, 3),
         "conv5": (512, 512, 3)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def vgg_tensors(scope, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for block, (cin, cout, n) in VGG16.items():
        for i in range(1, n + 1):
            c = cin if i == 1 else cout
            out[f"{scope}/{block}/{block}_{i}/weights"] = rng.standard_normal((3, 3, c, cout)).astype(np.float32)
            out[f"{scope}/{block}/{block}_{i}/biases"] = rng.standard_normal(cout).astype(np.float32)
    out[f"{scope}/fc6/weights"] = rng.standard_normal((3, 3, 512, 1024)).astype(np.float32)
    out[f"{scope}/fc6/biases"] = rng.standard_normal(1024).astype(np.float32)
    out[f"{scope}/fc7/weights"] = rng.standard_normal((1, 1, 1024, 1024)).astype(np.float32)
    out[f"{scope}/fc7/biases"] = rng.standard_normal(1024).astype(np.float32)
    return out


def saver_bundle(tf, tensors, prefix):
    """Write `tensors` and an int64 global_step through a TF1 Saver, as the
    reference's training wrote its checkpoints."""
    tf1 = tf.compat.v1
    graph = tf1.Graph()
    with graph.as_default():
        for name, value in tensors.items():
            tf1.Variable(value, name=name)
        tf1.train.get_or_create_global_step()
        step = tf1.assign(tf1.train.get_global_step(), 1234)
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            sess.run(step)
            return tf1.train.Saver().save(sess, prefix, write_meta_graph=False)


@pytest.fixture(scope="module")
def vgg_bundle(tmp_path_factory):
    tf = pytest.importorskip("tensorflow")
    tensors = vgg_tensors("vgg_16")
    prefix = saver_bundle(tf, tensors, str(tmp_path_factory.mktemp("slim") / "vgg_16.ckpt"))
    return tf, prefix, tensors


def test_reader_equals_tensorflow_and_jax(vgg_bundle):
    tf, prefix, tensors = vgg_bundle
    ours, theirs, tf_reader = TFCheckpointReader(prefix), jax_tf.TFCheckpointReader(prefix), tf.train.load_checkpoint(prefix)
    assert ours.variable_names() == theirs.variable_names() == sorted([*tensors, "global_step"])
    assert ours.raw_names() == theirs.raw_names()
    for name in ours.variable_names():
        got = ours.get_tensor(name)
        ref = tf_reader.get_tensor(name)
        assert got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref), name
        assert np.array_equal(got, theirs.get_tensor(name)) and got.dtype == theirs.get_tensor(name).dtype
    assert ours.get_tensor("global_step").dtype == np.int64 and int(ours.get_tensor("global_step")) == 1234
    loaded = ours.load_all()
    assert all(np.array_equal(loaded[k], v) for k, v in tensors.items())


@pytest.mark.parametrize("backbone_prefix", ["backbone", ""])
def test_slim_vgg_to_flat_equals_jax(vgg_bundle, backbone_prefix):
    _, prefix, _ = vgg_bundle
    tensors = TFCheckpointReader(prefix).load_all()
    ours = slim_vgg_to_flat(tensors, source_scope="vgg_16", backbone_prefix=backbone_prefix)
    theirs = jax_tf.slim_vgg_to_flat(tensors, source_scope="vgg_16", backbone_prefix=backbone_prefix)
    assert list(ours) == list(theirs) and len(ours) == 30
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


def test_compressed_index_blocks_are_refused(vgg_bundle, tmp_path):
    _, prefix, _ = vgg_bundle
    raw = bytearray(Path(prefix + ".index").read_bytes())
    # the index block's handle sits in the footer; its block's type byte follows the block
    footer = bytes(raw[-48:])
    from ron_tensorflow_tpu_torch.data.example import _read_varint

    pos = 0
    for _ in range(2):
        _, pos = _read_varint(footer, pos)
    off, pos = _read_varint(footer, pos)
    size, _ = _read_varint(footer, pos)
    raw[off + size] = 1  # snappy
    bad = tmp_path / "bad.ckpt"
    Path(str(bad) + ".index").write_bytes(bytes(raw))
    with pytest.raises(NotImplementedError, match="compressed"):
        TFCheckpointReader(str(bad))
    with pytest.raises(NotImplementedError, match="compressed"):
        jax_tf.TFCheckpointReader(str(bad))


@pytest.fixture(scope="module")
def reference_weights():
    """The 184 slim tensors of the reference's RON-320, regenerated by name."""
    fx = np.load(FIXTURE, allow_pickle=False)
    names = [str(n) for n in fx["var_names"]]
    shapes = json.loads(str(fx["var_shapes"]))
    return fx, {n: weight_for(n, s) for n, s in zip(names, shapes)}


def test_chip_smoke_weight_for_equals_the_tool(reference_weights):
    _, tensors = reference_weights
    for name, value in tensors.items():
        got = chip_smoke.weight_for(name, value.shape)
        assert got.dtype == value.dtype and np.array_equal(got, value), name


def test_slim_ron_to_flat_equals_jax_on_the_reference_names(reference_weights):
    _, tensors = reference_weights
    ours_p, ours_s = slim_ron_to_flat(tensors)
    theirs_p, theirs_s = jax_tf.slim_ron_to_flat(tensors)
    assert len(tensors) == 184 and len(ours_p) + len(ours_s) == 184
    for ours, theirs in ((ours_p, theirs_p), (ours_s, theirs_s)):
        assert list(ours) == list(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
            assert np.array_equal(ours[k], theirs[k]), k


def test_ron_320_forward_on_imported_weights_meets_the_reference_graph(reference_weights):
    """tests/test_model_parity.py's bounds, on the port: logits,
    objectness logits and locations within 2e-3 x max(1, |ref|max);
    probabilities within 5e-4. The f32 forward against the reference graph's
    outputs, and the float64 forward against them and against the f32 one.
    The convolutions run outside oneDNN, whose f32 kernels on this CPU carry
    3x the roundoff of torch's own (im2col and GEMM): through oneDNN the
    probabilities lie 7.8e-4 from the graph's, through torch's own 3.7e-4 (at
    4 threads; 4.8e-4 at 8); the graph's outputs are f32 themselves, 2.5e-4
    from float64."""
    fx, tensors = reference_weights
    state = from_jax_params(*slim_ron_to_flat(tensors))
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = RON(RON_320_SPEC, dtype=dtype)
        model.load_state_dict(state, strict=True)
        with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
            out[dtype] = model.to(dtype)(torch.from_numpy(fx["input"]).to(dtype))
    for got, ref in ((out[torch.float32], fx), (out[torch.float64], fx), (out[torch.float32], out[torch.float64])):
        errs = chip_smoke.reference_errors(got, ref)
        for field in ("logits", "objness_logits", "locations"):
            assert errs[field] <= 2e-3 * errs[f"{field}_scale"], (field, errs)
        for field in ("predictions", "objness_pred"):
            assert errs[field] <= 5e-4, (field, errs)
        assert errs["within"]
