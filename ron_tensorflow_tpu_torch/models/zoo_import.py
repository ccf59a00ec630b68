"""Weight importers of the backbone zoo: torchvision's Inception-V3 and
keras.applications' Xception and Inception-ResNet-V2.

A copy of `ron_tensorflow_tpu/models/zoo_import.py` (numpy only). Each
importer returns the flax variables {'params': ..., 'batch_stats': ...}
of the JAX package's zoo network, as nested dicts under the flax names;
flatten them (`train.checkpoint.flatten_params`) and load them with
`weights.from_jax_params` into the port's `models.zoo` network:

- `inception_v3_from_torch`: a torchvision `inception_v3` state_dict (the
  public checkpoints' layout, `Inception_V3_Weights.IMAGENET1K_V1`; torch
  tensors or numpy arrays) -> `InceptionV3(num_classes=1000)`; conv OIHW ->
  HWIO, BN affine and running statistics, the fc head; `AuxLogits.*` is
  ignored (a train-time head the model lacks).
- `xception_from_keras`, `inception_resnet_v2_from_keras`: an ordered list
  of (layer name, [weight arrays]) as
  `[(l.name, l.get_weights()) for l in keras_model.layers if l.get_weights()]`
  gives it, so no TensorFlow import happens here (ref: nets/xception.py:156-283,
  the reference's Keras-weights intent). Inception-ResNet-V2's importer
  takes the full depth (10/20/9 blocks).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

# torchvision module name -> our flax ConvBN name, per block family.
_STEM = {
    "Conv2d_1a_3x3": "stem1",
    "Conv2d_2a_3x3": "stem2",
    "Conv2d_2b_3x3": "stem3",
    "Conv2d_3b_1x1": "stem4",
    "Conv2d_4a_3x3": "stem5",
}
_A = {
    "branch1x1": "b0_1x1",
    "branch5x5_1": "b1_1x1",
    "branch5x5_2": "b1_5x5",
    "branch3x3dbl_1": "b2_1x1",
    "branch3x3dbl_2": "b2_3x3a",
    "branch3x3dbl_3": "b2_3x3b",
    "branch_pool": "b3_1x1",
}
_B = {
    "branch3x3": "b0_3x3",
    "branch3x3dbl_1": "b1_1x1",
    "branch3x3dbl_2": "b1_3x3a",
    "branch3x3dbl_3": "b1_3x3b",
}
_C = {
    "branch1x1": "b0_1x1",
    "branch7x7_1": "b1_1x1",
    "branch7x7_2": "b1_1x7",
    "branch7x7_3": "b1_7x1",
    "branch7x7dbl_1": "b2_1x1",
    "branch7x7dbl_2": "b2_7x1a",
    "branch7x7dbl_3": "b2_1x7a",
    "branch7x7dbl_4": "b2_7x1b",
    "branch7x7dbl_5": "b2_1x7b",
    "branch_pool": "b3_1x1",
}
_D = {
    "branch3x3_1": "b0_1x1",
    "branch3x3_2": "b0_3x3",
    "branch7x7x3_1": "b1_1x1",
    "branch7x7x3_2": "b1_1x7",
    "branch7x7x3_3": "b1_7x1",
    "branch7x7x3_4": "b1_3x3",
}
_E = {
    "branch1x1": "b0_1x1",
    "branch3x3_1": "b1_1x1",
    "branch3x3_2a": "b1_1x3",
    "branch3x3_2b": "b1_3x1",
    "branch3x3dbl_1": "b2_1x1",
    "branch3x3dbl_2": "b2_3x3",
    "branch3x3dbl_3a": "b2_1x3",
    "branch3x3dbl_3b": "b2_3x1",
    "branch_pool": "b3_1x1",
}
_MIXED = {
    "Mixed_5b": ("mixed_5b", _A),
    "Mixed_5c": ("mixed_5c", _A),
    "Mixed_5d": ("mixed_5d", _A),
    "Mixed_6a": ("mixed_6a", _B),
    "Mixed_6b": ("mixed_6b", _C),
    "Mixed_6c": ("mixed_6c", _C),
    "Mixed_6d": ("mixed_6d", _C),
    "Mixed_6e": ("mixed_6e", _C),
    "Mixed_7a": ("mixed_7a", _D),
    "Mixed_7b": ("mixed_7b", _E),
    "Mixed_7c": ("mixed_7c", _E),
}


def _to_np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def inception_v3_from_torch(state_dict: Dict[str, Any]) -> Dict:
    """torchvision inception_v3 state_dict -> flax variables for
    `zoo.InceptionV3(num_classes=1000)`.

    Returns {'params': ..., 'batch_stats': ...}. AuxLogits.* entries are
    ignored (train-time-only head, absent from our model).
    """
    sd = {k: _to_np(v) for k, v in state_dict.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put_convbn(flax_path: Tuple[str, ...], torch_prefix: str):
        # ConvBN param layout: <block>/<branch>/conv/{conv:{kernel}, bn:...}
        node = params
        for p in flax_path + ("conv",):
            node = node.setdefault(p, {})
        node["conv"] = {
            "kernel": np.transpose(sd[f"{torch_prefix}.conv.weight"], (2, 3, 1, 0))
        }
        node["bn"] = {
            "scale": sd[f"{torch_prefix}.bn.weight"],
            "bias": sd[f"{torch_prefix}.bn.bias"],
        }
        snode = stats
        for p in flax_path + ("conv",):
            snode = snode.setdefault(p, {})
        snode["bn"] = {
            "mean": sd[f"{torch_prefix}.bn.running_mean"],
            "var": sd[f"{torch_prefix}.bn.running_var"],
        }

    for torch_name, flax_name in _STEM.items():
        put_convbn((flax_name,), torch_name)
    for torch_block, (flax_block, table) in _MIXED.items():
        for torch_branch, flax_branch in table.items():
            put_convbn((flax_block, flax_branch), f"{torch_block}.{torch_branch}")

    params["logits"] = {
        "kernel": np.transpose(sd["fc.weight"], (1, 0)),
        "bias": sd["fc.bias"],
    }
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# Keras-applications weight import (Xception, InceptionResNetV2) — the
# reference's own Keras-weights intent for these nets
# (ref: nets/xception.py:156-283 `xception_keras_arg_scope` /
#  nets/inception_resnet_v2.py). The importers take an ORDERED list of
# (layer_name, [weight arrays]) as produced by
#   [(l.name, l.get_weights()) for l in keras_model.layers if l.get_weights()]
# so no TF import happens here.
# ---------------------------------------------------------------------------


def _put(tree: Dict, path: Tuple[str, ...], leaf: str, arr: np.ndarray):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = arr


def _put_bn(params, stats, path, w, scale=None):
    """Keras BatchNormalization weights -> our BatchNorm leaves.

    w is keras .get_weights(): [gamma, beta, mean, var] when scale=True
    (Xception) or [beta, mean, var] when scale=False (InceptionResNetV2 —
    gamma synthesized as ones)."""
    if len(w) == 4:
        gamma, beta, mean, var = w
    else:
        beta, mean, var = w
        gamma = np.ones_like(beta)
    _put(params, path, "scale", gamma)
    _put(params, path, "bias", beta)
    _put(stats, path, "mean", mean)
    _put(stats, path, "var", var)


def xception_from_keras(layer_weights) -> Dict:
    """keras.applications.Xception weights -> flax variables for
    `zoo.Xception(num_classes=1000)`.

    Keras layer names are explicit in the keras source (block1_conv1,
    blockN_sepconvM, predictions); only the four residual-shortcut convs are
    auto-named (conv2d*, batch_normalization*) and map by order of
    appearance: entry blocks 1-3, then the exit shortcut."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    # keras block index -> our module name
    entry = {2: "entry_block1", 3: "entry_block2", 4: "entry_block3"}
    shortcut_targets = ["entry_block1", "entry_block2", "entry_block3", None]
    sc_conv = sc_bn = 0

    for name, w in layer_weights:
        if name.startswith("block1_conv"):
            tgt = "entry1" if name.startswith("block1_conv1") else "entry2"
            if name.endswith("_bn"):
                _put_bn(params, stats, (tgt, "conv", "bn"), w)
            else:
                _put(params, (tgt, "conv", "conv"), "kernel", w[0])
        elif name.startswith("conv2d"):
            tgt = shortcut_targets[sc_conv]
            sc_conv += 1
            path = (tgt, "shortcut") if tgt else ("exit_shortcut",)
            _put(params, path, "kernel", w[0])
        elif name.startswith("batch_normalization"):
            tgt = shortcut_targets[sc_bn]
            sc_bn += 1
            path = (tgt, "shortcut_bn") if tgt else ("exit_shortcut_bn",)
            _put_bn(params, stats, path, w)
        elif "_sepconv" in name:
            blk = int(name.split("_")[0][5:])  # blockN
            sep = name.split("_sepconv")[1][0]  # 1/2/3
            if blk in entry:
                mod = (entry[blk], f"sep{sep}")
            elif 5 <= blk <= 12:
                mod = (f"middle{blk - 4}_sep{sep}",)
            elif blk == 13:
                mod = (f"exit_sep{sep}",)
            else:  # block14: sepconv1 -> exit_sep3, sepconv2 -> exit_sep4
                mod = (f"exit_sep{int(sep) + 2}",)
            if name.endswith("_bn"):
                _put_bn(params, stats, mod + ("bn",), w)
            else:
                _put(params, mod, "depthwise",
                     {"kernel": np.transpose(w[0], (0, 1, 3, 2))})
                _put(params, mod, "pointwise", {"kernel": w[1]})
        elif name == "predictions":
            params["logits"] = {"kernel": w[0], "bias": w[1]}
    return {"params": params, "batch_stats": stats}


def _irv2_target_order(blocks35=10, blocks17=20, blocks8=9):
    """Our InceptionResnetV2 ConvBN/up-conv paths in keras build order.
    Yields ('convbn', path) for conv2d_bn pairs and ('conv', path) for the
    biased 'up' projections; ends with ('dense', ('logits',))."""
    order = []
    for s in ("stem1", "stem2", "stem3", "stem4", "stem5"):
        order.append(("convbn", (s,)))
    for b in ("m5b_b0", "m5b_b1a", "m5b_b1b", "m5b_b2a", "m5b_b2b",
              "m5b_b2c", "m5b_b3"):
        order.append(("convbn", (b,)))
    for i in range(blocks35):
        for b in ("b0", "b1a", "b1b", "b2a", "b2b", "b2c"):
            order.append(("convbn", (f"block35_{i + 1}", b)))
        order.append(("conv", (f"block35_{i + 1}", "up")))
    for b in ("ra_b0", "ra_b1a", "ra_b1b", "ra_b1c"):
        order.append(("convbn", (b,)))
    for i in range(blocks17):
        for b in ("b0", "b1a", "b1b", "b1c"):
            order.append(("convbn", (f"block17_{i + 1}", b)))
        order.append(("conv", (f"block17_{i + 1}", "up")))
    for b in ("rb_b0a", "rb_b0b", "rb_b1a", "rb_b1b", "rb_b2a", "rb_b2b",
              "rb_b2c"):
        order.append(("convbn", (b,)))
    for i in range(blocks8 + 1):  # +1: the final unscaled block8
        tag = f"block8_{i + 1}" if i < blocks8 else "block8_final"
        for b in ("b0", "b1a", "b1b", "b1c"):
            order.append(("convbn", (tag, b)))
        order.append(("conv", (tag, "up")))
    order.append(("convbn", ("conv7b",)))
    order.append(("dense", ("logits",)))
    return order


def _keras_creation_index(name, family):
    """Index of an auto-named keras layer within its name family
    ('conv2d' -> 0, 'conv2d_7' -> 7); None for explicit names."""
    if name == family:
        return 0
    suffix = name[len(family) + 1:]
    if name.startswith(family + "_") and suffix.isdigit():
        return int(suffix)
    return None


def inception_resnet_v2_from_keras(layer_weights) -> Dict:
    """keras.applications.InceptionResNetV2 weights -> flax variables for
    `zoo.InceptionResnetV2(num_classes=1000)`.

    Keras auto-names most of these layers, and `model.layers` is
    TOPOLOGICAL (breadth-first by depth), not creation order -- but the
    auto-name counters ('conv2d_7', 'batch_normalization_7') ARE creation
    order, which equals our build order (branches b0..b3 then merge, like
    the slim reference). So: bucket weighted layers by kind, sort each
    bucket by its name counter (explicit names like 'conv_7b' sort last --
    they are created last), pair the i-th BatchNormalization with the i-th
    kernel-only Conv2D (conv2d_bn creates them in lockstep; the BNs are
    scale=False), and zip with our target order. Block 'up' projections
    arrive as biased Conv2D with no BN; 'predictions' is the dense head."""
    convs_bn, ups, bns, dense = [], [], [], None
    for name, w in layer_weights:
        shapes = [a.shape for a in w]
        if len(w) == 1 and len(shapes[0]) == 4:
            convs_bn.append((name, w))
        elif len(w) == 2 and len(shapes[0]) == 4:
            ups.append((name, w))
        elif len(shapes[0]) == 1 and len(w) in (3, 4):
            bns.append((name, w))
        elif len(w) == 2 and len(shapes[0]) == 2:
            dense = (name, w)
        else:
            raise ValueError(f"unrecognized keras layer {name}: {shapes}")

    def creation_order(family):
        def key(item):
            idx = _keras_creation_index(item[0], family)
            return (1, item[0]) if idx is None else (0, idx)

        return key

    convs_bn.sort(key=creation_order("conv2d"))
    bns.sort(key=creation_order("batch_normalization"))
    assert len(convs_bn) == len(bns), (len(convs_bn), len(bns))

    targets = _irv2_target_order()
    t_convbn = [p for k, p in targets if k == "convbn"]
    assert len(t_convbn) == len(convs_bn), (len(t_convbn), len(convs_bn))

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for path, (_, cw), (_, bw) in zip(t_convbn, convs_bn, bns):
        _put(params, path + ("conv", "conv"), "kernel", cw[0])
        _put_bn(params, stats, path + ("conv", "bn"), bw)

    # block 'up' projections carry EXPLICIT keras names (block35_7_conv,
    # block8_10_conv) -- map by name; the highest block8 index is the final
    # unscaled block (our 'block8_final').
    import re

    n_block8 = max(
        int(re.match(r"block8_(\d+)_conv$", n).group(1))
        for n, _ in ups
        if re.match(r"block8_(\d+)_conv$", n)
    )
    for name, uw in ups:
        m = re.match(r"block(35|17|8)_(\d+)_conv$", name)
        assert m, f"unexpected biased conv {name}"
        kind, idx = m.group(1), int(m.group(2))
        tag = (
            "block8_final"
            if kind == "8" and idx == n_block8
            else f"block{kind}_{idx}"
        )
        _put(params, (tag, "up"), "kernel", uw[0])
        _put(params, (tag, "up"), "bias", uw[1])
    assert dense is not None, "missing predictions dense layer"
    params["logits"] = {"kernel": dense[1][0], "bias": dense[1][1]}
    return {"params": params, "batch_stats": stats}
