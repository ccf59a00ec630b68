"""Caffe `.caffemodel` weight import, with no caffe or protobuf dependency.

A copy of `ron_tensorflow_tpu/train/caffe_import.py` (ref:
nets/caffe_scope.py:15-90, caffe_to_tensorflow.py:30-65,
convert_caffe_ron.py): the caffemodel (a serialized NetParameter proto) is
walked with the wire-format reader of `data/example.py`, extracting each
layer's blobs.

Weight conventions (ref: nets/caffe_scope.py:33-56): conv blobs are
[out, in, kh, kw] -> transposed to HWIO (flax's layout; `weights.
from_jax_params` takes them into the port's modules); the FIRST conv
optionally flips its input channels BGR->RGB; biases pass through;
L2-normalization scale blobs map to the `gamma` of the L2Normalization
layers.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.example import _iter_fields, _read_varint


def _parse_blob(buf: bytes) -> np.ndarray:
    """BlobProto -> ndarray. shape: field 7 (BlobShape.dim=1) or legacy
    num/channels/height/width fields 1-4; data: packed floats field 5."""
    shape: List[int] = []
    legacy = {}
    data = np.zeros((0,), np.float32)
    for field, wire, val in _iter_fields(buf):
        if field == 7 and wire == 2:  # BlobShape
            for f2, w2, v2 in _iter_fields(val):
                if f2 != 1:
                    continue
                if w2 == 2:  # packed
                    pos = 0
                    while pos < len(v2):
                        d, pos = _read_varint(v2, pos)
                        shape.append(d)
                else:
                    shape.append(v2)
        elif field in (1, 2, 3, 4) and wire == 0:
            legacy[field] = val
        elif field == 5:  # data (repeated float)
            if wire == 2:
                data = np.frombuffer(val, dtype="<f4").copy()
            else:
                data = np.append(data, struct.unpack("<f", val)[0])
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape:
        data = data.reshape(shape)
    return data


def parse_caffemodel(path: str) -> Dict[str, Tuple[str, List[np.ndarray]]]:
    """Read a .caffemodel: {layer name: (layer type, [blobs...])}.

    Supports the modern `layer` (field 100) and V1 `layers` (field 2)
    encodings of NetParameter.
    """
    with open(path, "rb") as f:
        buf = f.read()
    layers: Dict[str, Tuple[str, List[np.ndarray]]] = {}
    for field, wire, val in _iter_fields(buf):
        if wire != 2 or field not in (100, 2):
            continue
        name, ltype = "", ""
        blobs: List[np.ndarray] = []
        if field == 100:  # LayerParameter: name=1, type=2, blobs=7
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    name = v2.decode(errors="replace")
                elif f2 == 2 and w2 == 2:
                    ltype = v2.decode(errors="replace")
                elif f2 == 7 and w2 == 2:
                    blobs.append(_parse_blob(v2))
        else:  # V1LayerParameter: name=4, type=5 (enum), blobs=6
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 4 and w2 == 2:
                    name = v2.decode(errors="replace")
                elif f2 == 5 and w2 == 0:
                    ltype = f"v1:{v2}"
                elif f2 == 6 and w2 == 2:
                    blobs.append(_parse_blob(v2))
        if name and blobs:
            layers[name] = (ltype, blobs)
    return layers


def caffe_vgg_to_flat(
    layers: Dict[str, Tuple[str, List[np.ndarray]]],
    backbone_prefix: str = "backbone",
    bgr_to_rgb: bool = True,
    name_map: Optional[Dict[str, str]] = None,
) -> Dict[str, np.ndarray]:
    """Map caffe conv layers onto our flat param names.

    Caffe VGG layer names ('conv1_1' .. 'conv5_3', 'fc6', 'fc7') match our
    module names directly; `name_map` overrides for exotic nets. Norm-scale
    blobs (single blob, 1-D) become L2Normalization gammas.
    """
    flat: Dict[str, np.ndarray] = {}
    # SSD trees keep the VGG convs at top level — backbone_prefix='' emits
    # unprefixed keys.
    pfx = f"{backbone_prefix}/" if backbone_prefix else ""
    first_conv_seen = False
    for name, (_, blobs) in layers.items():
        target = (name_map or {}).get(name, name)
        if len(blobs) >= 1 and blobs[0].ndim == 4:
            w = np.transpose(blobs[0], (2, 3, 1, 0))  # OIHW -> HWIO
            if bgr_to_rgb and not first_conv_seen:
                w = w[:, :, ::-1, :]
            first_conv_seen = True
            flat[f"{pfx}{target}/conv/kernel"] = w.astype(np.float32)
            if len(blobs) > 1:
                flat[f"{pfx}{target}/conv/bias"] = blobs[1].reshape(-1).astype(
                    np.float32
                )
        elif len(blobs) == 1 and blobs[0].ndim <= 2:
            # normalization scale (e.g. SSD block4 L2Norm)
            flat[f"{target}/l2_norm/gamma"] = blobs[0].reshape(-1).astype(np.float32)
    return flat
