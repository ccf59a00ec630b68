"""The port's Caffe importer against the JAX package's, on caffemodels
hand-encoded here in every blob and layer encoding the parser reads."""

import numpy as np
import pytest

from ron_tensorflow_tpu.train import caffe_import as jax_caffe

from ron_tensorflow_tpu_torch.data.example import _len_delimited, _tag, _varint
from ron_tensorflow_tpu_torch.train.caffe_import import caffe_vgg_to_flat, parse_caffemodel

VGG = (("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128), ("conv4_3", 128, 32), ("fc7", 32, 16))


def encode_blob(arr: np.ndarray, shape: str) -> bytes:
    """BlobProto: dims as a packed BlobShape (field 7), as unpacked BlobShape
    dims, or as the legacy num/channels/height/width fields 1-4; data as
    packed floats (field 5), or one float per field for small blobs."""
    if shape == "packed":
        blob = _len_delimited(7, _len_delimited(1, b"".join(_varint(d) for d in arr.shape)))
    elif shape == "unpacked":
        blob = _len_delimited(7, b"".join(_tag(1, 0) + _varint(d) for d in arr.shape))
    else:
        dims = (1,) * (4 - arr.ndim) + arr.shape
        blob = b"".join(_tag(f, 0) + _varint(d) for f, d in zip((1, 2, 3, 4), dims))
    if arr.size <= 8:
        return blob + b"".join(_tag(5, 5) + v.tobytes() for v in arr.astype("<f4").reshape(-1))
    return blob + _len_delimited(5, arr.astype("<f4").tobytes())


def encode_layer(name, ltype, blobs, shape, v1=False) -> bytes:
    if v1:  # V1LayerParameter: name 4, type 5 (an enum), blobs 6, under NetParameter.layers = 2
        msg = _len_delimited(4, name.encode()) + _tag(5, 0) + _varint(4)
        msg += b"".join(_len_delimited(6, encode_blob(b, shape)) for b in blobs)
        return _len_delimited(2, msg)
    msg = _len_delimited(1, name.encode()) + _len_delimited(2, ltype.encode())
    msg += b"".join(_len_delimited(7, encode_blob(b, shape)) for b in blobs)
    return _len_delimited(100, msg)


def caffemodel(tmp_path, shape, v1, seed=0):
    rng = np.random.default_rng(seed)
    net, blobs = b"", {}
    for name, cin, cout in VGG:
        w = rng.standard_normal((cout, cin, 3, 3)).astype(np.float32)
        b = rng.standard_normal(cout).astype(np.float32)
        blobs[name] = [w, b]
        net += encode_layer(name, "Convolution", [w, b], shape, v1)
        if name == "conv4_3":
            gamma = rng.uniform(10, 30, (cout,)).astype(np.float32)
            blobs["conv4_3_norm"] = [gamma]
            net += encode_layer("conv4_3_norm", "Normalize", [gamma], shape, v1)
    net += encode_layer("relu1_1", "ReLU", [], shape, v1)  # no blobs: not listed
    bias_only = rng.standard_normal(3).astype(np.float32)
    blobs["tiny"] = [bias_only]
    net += encode_layer("tiny", "Scale", [bias_only], shape, v1)
    path = tmp_path / f"{shape}_{v1}.caffemodel"
    path.write_bytes(net)
    return str(path), blobs


@pytest.mark.parametrize("v1", [False, True], ids=["layer", "v1_layers"])
@pytest.mark.parametrize("shape", ["packed", "unpacked", "legacy"])
def test_parse_caffemodel_equals_jax(shape, v1, tmp_path):
    path, blobs = caffemodel(tmp_path, shape, v1)
    ours, theirs = parse_caffemodel(path), jax_caffe.parse_caffemodel(path)
    assert list(ours) == list(theirs) == list(blobs)
    for name, (ltype, arrays) in ours.items():
        assert ltype == theirs[name][0] == ("v1:4" if v1 else ("Normalize" if name.endswith("norm") else
                                                                "Scale" if name == "tiny" else "Convolution"))
        want = [a.reshape((1,) * (4 - a.ndim) + a.shape) if shape == "legacy" else a for a in blobs[name]]
        for got, ref, src in zip(arrays, theirs[name][1], want, strict=True):
            assert got.dtype == ref.dtype and np.array_equal(got, ref) and np.array_equal(got, src)


@pytest.mark.parametrize("bgr_to_rgb", [False, True])
@pytest.mark.parametrize("backbone_prefix", ["backbone", ""])
def test_caffe_vgg_to_flat_equals_jax(bgr_to_rgb, backbone_prefix, tmp_path):
    path, blobs = caffemodel(tmp_path, "packed", False, seed=1)
    layers = parse_caffemodel(path)
    ours = caffe_vgg_to_flat(layers, backbone_prefix=backbone_prefix, bgr_to_rgb=bgr_to_rgb)
    theirs = jax_caffe.caffe_vgg_to_flat(jax_caffe.parse_caffemodel(path), backbone_prefix=backbone_prefix,
                                         bgr_to_rgb=bgr_to_rgb)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == np.float32 and np.array_equal(ours[k], theirs[k]), k
    pfx = f"{backbone_prefix}/" if backbone_prefix else ""
    k11 = np.transpose(blobs["conv1_1"][0], (2, 3, 1, 0))
    assert np.array_equal(ours[f"{pfx}conv1_1/conv/kernel"], k11[:, :, ::-1] if bgr_to_rgb else k11)
    assert np.array_equal(ours[f"{pfx}conv1_2/conv/kernel"], np.transpose(blobs["conv1_2"][0], (2, 3, 1, 0)))
    assert np.array_equal(ours["conv4_3_norm/l2_norm/gamma"], blobs["conv4_3_norm"][0])
    assert np.array_equal(ours["tiny/l2_norm/gamma"], blobs["tiny"][0])  # a 1-D single blob is a norm scale
