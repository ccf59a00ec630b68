"""Detector modules (NCHW inside, the JAX layout at the outputs): RON and
SSD through `get_network`; the classification zoo (the VGG classifiers,
Inception-V3, Xception, Inception-ResNet-V2) by class, outside the
registry, as in the JAX package."""

from __future__ import annotations

import torch

from .layers import shard_model  # noqa: F401  (distribution over a parallel.mesh.Mesh)
from .vgg import VGG16Backbone, VGG16Classifier, VGGBackbone  # noqa: F401
from .zoo import InceptionResnetV2, InceptionV3, Xception  # noqa: F401


def _registry():
    from .ron import RON
    from .spec import RON_320_SPEC, RON_TINY_SPEC, SSD_300_SPEC, SSD_512_SPEC
    from .ssd import SSD

    return {
        "ron_320_vgg": (RON, RON_320_SPEC, {"backbone_variant": "reduced"}),
        "ron_320_vgg_heavy": (RON, RON_320_SPEC, {"backbone_variant": "heavy"}),
        "ron_tiny_vgg": (RON, RON_TINY_SPEC, {}),
        "ssd_300_vgg": (SSD, SSD_300_SPEC, {}),
        "ssd_512_vgg": (SSD, SSD_512_SPEC, {}),
        "ssd_300_vgg_caffe": (SSD, SSD_300_SPEC, {}),
        "ssd_512_vgg_caffe": (SSD, SSD_512_SPEC, {}),
    }


def get_spec(name: str):
    """The DetectorSpec of a registered network, without building it."""
    registry = _registry()
    if name not in registry:
        raise ValueError(f"unknown network {name!r}; options: {sorted(registry)}")
    return registry[name][1]


def get_network(name: str, dtype: torch.dtype = torch.float32, **kwargs):
    """Model registry (`ron_tensorflow_tpu/models/__init__.py::get_network`):
    name -> (module, DetectorSpec). `kwargs` go to the module: `RON`'s
    (fuse_block1, s2d_stem, remat_blocks12, bn_fast_normalize) or `SSD`'s
    (fuse_block1, s2d_stem, dropout_rate).
    The reference's *_caffe entries differ only in how their weights were
    first seeded, so they name the same two SSD architectures."""
    spec = get_spec(name)
    cls, _, fixed = _registry()[name]
    return cls(spec, dtype=dtype, **fixed, **kwargs), spec
