"""TensorFlow checkpoint (V2 "bundle") reader, pure Python, no TF import.

A copy of `ron_tensorflow_tpu/train/tf_checkpoint.py`: the reader of the
reference's published TF1 checkpoints (the reduced RON-320 ckpt and the
`vgg16_reducedfc` init, ref: README.md:23,28,36; restore machinery
tf_utils.py:186-244), and the slim -> flax name mappings. The mappings give
flax-flat names in flax layouts (HWIO kernels; TF's [kh, kw, OUT, IN]
deconv kernels flipped and transposed to [kh, kw, IN, OUT]), which
`weights.from_jax_params` carries into the port's modules.

Format: `<prefix>.index` is a LevelDB-style table mapping tensor names to
BundleEntryProto records (shard, offset, size, dtype, shape); the
`<prefix>.data-NNNNN-of-MMMMM` shards hold raw little-endian tensor bytes.
The index is written uncompressed by TF's BundleWriter; this reader
supports uncompressed blocks (and raises clearly otherwise).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.example import _iter_fields, _read_varint

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy dtype (subset used by checkpoints)
_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    5: np.int16,
    6: np.int8,
    9: np.int64,
    10: np.bool_,
    14: np.uint16,  # bfloat16 stored as uint16 (caller reinterprets)
    19: np.float16,
}


def _read_block(buf: bytes, offset: int, size: int) -> bytes:
    """A table block: payload + 1-byte compression type + 4-byte crc."""
    ctype = buf[offset + size]
    if ctype != 0:
        raise NotImplementedError(
            f"compressed checkpoint index blocks (type {ctype}) not supported"
        )
    return buf[offset : offset + size]


def _iter_block_entries(block: bytes):
    """Iterate (key, value) of a LevelDB table block (prefix-compressed)."""
    if len(block) < 4:
        return
    (num_restarts,) = struct.unpack("<I", block[-4:])
    data_end = len(block) - 4 - 4 * num_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def _decode_handle(value: bytes) -> Tuple[int, int]:
    """BlockHandle: varint offset + varint size."""
    offset, pos = _read_varint(value, 0)
    size, _ = _read_varint(value, pos)
    return offset, size


class BundleEntry:
    def __init__(self, dtype, shape, shard_id, offset, size):
        self.dtype = dtype  # numpy dtype, or None for unsupported (e.g. string)
        self.shape = shape
        self.shard_id = shard_id
        self.offset = offset
        self.size = size


def _parse_entry(value: bytes) -> BundleEntry:
    """BundleEntryProto: dtype=1, shape=2 (TensorShapeProto.dim.size=2... the
    dim message has size field 1), shard_id=3, offset=4, size=5."""
    dtype = np.float32
    shape: List[int] = []
    shard_id = 0
    offset = 0
    size = 0
    for field, wire, val in _iter_fields(value):
        if field == 1 and wire == 0:
            dtype = _DTYPES.get(val)
        elif field == 2 and wire == 2:  # TensorShapeProto
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 2 and w2 == 2:  # Dim message
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1 and w3 == 0:
                            d = v3 if v3 < 1 << 63 else v3 - (1 << 64)
                            shape.append(d)
        elif field == 3 and wire == 0:
            shard_id = val
        elif field == 4 and wire == 0:
            offset = val
        elif field == 5 and wire == 0:
            size = val
    return BundleEntry(dtype, shape, shard_id, offset, size)


class TFCheckpointReader:
    """Random-access reader over a TF V2 checkpoint.

    Usage:
        r = TFCheckpointReader("/path/model.ckpt")
        names = r.variable_names()
        arr = r.get_tensor("vgg_16/conv1/conv1_1/weights")
    """

    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(prefix + ".index", "rb") as f:
            buf = f.read()
        # Footer: metaindex handle + index handle (+ padding) + 8-byte magic.
        footer = buf[-48:]
        (magic,) = struct.unpack("<Q", footer[-8:])
        if magic != _TABLE_MAGIC:
            raise IOError(f"{prefix}.index: not a TF checkpoint index (bad magic)")
        pos = 0
        _, pos = _read_varint(footer, pos)  # metaindex offset
        _, pos = _read_varint(footer, pos)  # metaindex size
        idx_off, pos = _read_varint(footer, pos)
        idx_size, pos = _read_varint(footer, pos)
        index_block = _read_block(buf, idx_off, idx_size)

        self.entries: Dict[str, BundleEntry] = {}
        for _, handle in _iter_block_entries(index_block):
            off, size = _decode_handle(handle)
            for key, value in _iter_block_entries(_read_block(buf, off, size)):
                name = key.decode(errors="replace")
                if name.startswith("\x00") or not name:
                    continue  # header entry
                self.entries[name] = _parse_entry(value)

        self._num_shards: Optional[int] = None

    def variable_names(self) -> List[str]:
        """Numeric tensors only (string entries like the object graph are
        listed by `raw_names`)."""
        return sorted(n for n, e in self.entries.items() if e.dtype is not None)

    def raw_names(self) -> List[str]:
        return sorted(self.entries)

    def _shard_path(self, shard_id: int) -> str:
        if self._num_shards is None:
            import glob

            shards = glob.glob(self.prefix + ".data-*-of-*")
            if not shards:
                raise FileNotFoundError(f"no data shards for {self.prefix}")
            self._num_shards = len(shards)
        return f"{self.prefix}.data-{shard_id:05d}-of-{self._num_shards:05d}"

    def get_tensor(self, name: str) -> np.ndarray:
        e = self.entries[name]
        if e.dtype is None:
            raise TypeError(f"{name}: unsupported (non-numeric) dtype")
        with open(self._shard_path(e.shard_id), "rb") as f:
            f.seek(e.offset)
            raw = f.read(e.size)
        arr = np.frombuffer(raw, dtype=e.dtype)
        return arr.reshape(e.shape).copy()

    def load_all(self) -> Dict[str, np.ndarray]:
        return {name: self.get_tensor(name) for name in self.variable_names()}


# --------------------------------------------------------------------------- #
# slim (TF1) name mapping for RON/SSD VGG checkpoints
# --------------------------------------------------------------------------- #

_VGG_CONV_BLOCKS = {
    "conv1": ("conv1_1", "conv1_2"),
    "conv2": ("conv2_1", "conv2_2"),
    "conv3": ("conv3_1", "conv3_2", "conv3_3"),
    "conv4": ("conv4_1", "conv4_2", "conv4_3"),
    "conv5": ("conv5_1", "conv5_2", "conv5_3"),
}


def slim_vgg_to_flat(
    tensors: Dict[str, np.ndarray],
    source_scope: str = "ron_320_vgg",
    backbone_prefix: str = "backbone",
) -> Dict[str, np.ndarray]:
    """Map slim-style VGG tensor names to our flat param names.

    Handles `scope/convX/convX_Y/weights|biases` (slim repeat naming,
    ref: nets/ron_vgg_320.py:530-553) and flat `scope/fcN/weights|biases`.
    Weights are already HWIO in TF — no transpose needed.
    """
    flat: Dict[str, np.ndarray] = {}
    # SSD trees keep the VGG convs at top level — backbone_prefix='' emits
    # unprefixed keys.
    pfx = f"{backbone_prefix}/" if backbone_prefix else ""
    for name, arr in tensors.items():
        parts = name.split("/")
        if parts and parts[0] == source_scope:
            parts = parts[1:]
        if len(parts) >= 3 and parts[0] in _VGG_CONV_BLOCKS and parts[-1] in (
            "weights",
            "biases",
        ):
            conv_name = parts[1]
            kind = "kernel" if parts[-1] == "weights" else "bias"
            flat[f"{pfx}{conv_name}/conv/{kind}"] = arr
        elif len(parts) == 2 and parts[0].startswith("fc") and parts[-1] in (
            "weights",
            "biases",
        ):
            kind = "kernel" if parts[-1] == "weights" else "bias"
            flat[f"{pfx}{parts[0]}/conv/{kind}"] = arr
    return flat


_BN_PARAM = {"gamma": "scale", "beta": "bias"}
_BN_STAT = {"moving_mean": "mean", "moving_variance": "var"}


def _bn_flat(prefix: str, leaf: str, arr, params: Dict, stats: Dict) -> bool:
    if leaf in _BN_PARAM:
        params[f"{prefix}/{_BN_PARAM[leaf]}"] = arr
        return True
    if leaf in _BN_STAT:
        stats[f"{prefix}/{_BN_STAT[leaf]}"] = arr
        return True
    return False


def slim_ron_to_flat(
    tensors: Dict[str, np.ndarray],
    source_scope: str = "ron_320_vgg",
    backbone_prefix: str = "backbone",
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Map the FULL RON graph's slim tensor names (backbone + reverse modules
    + objectness/cls/box heads + BatchNorm) to our flat flax names.

    Slim naming source: nets/ron_vgg_320.py —
      reverse_module/{layer}_reverse_conv_left (+BatchNorm)          (:418-425)
      reverse_module/{layer}_reverse_deconv_right                    (:424)
      reverse_module/{layer}_reverse_objectness(+BN) / _score        (:428-430)
      reverse_module/{layer}_reverse_inception{1,2}/Branch_{0,1}/... (:378-399)
      reverse_module/{layer}_reverse/Conv2d_{0,1}_3x3                (:406-415)

    Deconv kernels are converted from TF's [kh, kw, OUT, IN] layout to our
    [kh, kw, IN, OUT] with a spatial flip — verified numerically exact
    against tf.nn.conv2d_transpose (see tools/reference_forward.py).

    Returns (params_flat, batch_stats_flat).
    """
    params = slim_vgg_to_flat(tensors, source_scope, backbone_prefix)
    stats: Dict[str, np.ndarray] = {}
    for name, arr in tensors.items():
        parts = name.split("/")
        if parts and parts[0] == source_scope:
            parts = parts[1:]
        if not parts or parts[0] != "reverse_module":
            continue
        parts = parts[1:]
        head, leaf = parts[0], parts[-1]

        def _layer_of(tag: str) -> str:
            return tag.split("_reverse")[0]

        if "_reverse_conv_left" in head:
            p = f"{_layer_of(head)}_reverse/conv_left"
            if leaf == "weights":
                params[f"{p}/conv/kernel"] = arr
            else:
                _bn_flat(f"{p}/bn", leaf, arr, params, stats)
        elif "_reverse_deconv_right" in head:
            p = f"{_layer_of(head)}_reverse/deconv_right"
            if leaf == "weights":
                params[f"{p}/deconv_kernel"] = arr[::-1, ::-1].transpose(0, 1, 3, 2)
            elif leaf == "biases":
                params[f"{p}/deconv_bias"] = arr
        elif "_reverse_objectness_score" in head:
            p = f"{_layer_of(head)}_objectness/score/conv"
            params[f"{p}/{'kernel' if leaf == 'weights' else 'bias'}"] = arr
        elif "_reverse_objectness" in head:
            p = f"{_layer_of(head)}_objectness/conv"
            if leaf == "weights":
                params[f"{p}/conv/kernel"] = arr
            else:
                _bn_flat(f"{p}/bn", leaf, arr, params, stats)
        elif "_reverse_inception" in head:
            layer = _layer_of(head)
            blk = "inception" + head.split("_reverse_inception")[1]
            if parts[1] == "BatchNorm":
                _bn_flat(f"{layer}_cls/{blk}_bn", leaf, arr, params, stats)
            elif parts[1].startswith("Branch_"):
                tap = "3x3" if parts[2] == "Conv2d_3x3" else "1x1"
                kind = "kernel" if leaf == "weights" else "bias"
                params[f"{layer}_cls/{blk}_{tap}/conv/{kind}"] = arr
            elif parts[1] == "Conv2d_pred_3x3":
                kind = "kernel" if leaf == "weights" else "bias"
                params[f"{layer}_cls/pred/conv/{kind}"] = arr
        elif head.endswith("_reverse"):  # reg_bbox_module under plain scope
            layer = _layer_of(head)
            if parts[1] == "Conv2d_0_3x3":
                if leaf == "weights":
                    params[f"{layer}_box/conv/conv/kernel"] = arr
                else:
                    _bn_flat(f"{layer}_box/conv/bn", leaf, arr, params, stats)
            elif parts[1] == "Conv2d_1_3x3":
                kind = "kernel" if leaf == "weights" else "bias"
                params[f"{layer}_box/pred/conv/{kind}"] = arr
    return params, stats
