"""RON-320 detector modules (NCHW inside, the JAX layout at the outputs)."""

from __future__ import annotations

import torch


def get_network(name: str, dtype: torch.dtype = torch.float32, **kwargs):
    """Model registry (`ron_tensorflow_tpu/models/__init__.py::get_network`):
    name -> (RON module, DetectorSpec). `kwargs` go to `RON` (fuse_block1,
    bn_fast_normalize). The heavy VGG variant and SSD are not ported yet."""
    from .ron import RON
    from .spec import RON_320_SPEC, RON_TINY_SPEC

    specs = {"ron_320_vgg": RON_320_SPEC, "ron_tiny_vgg": RON_TINY_SPEC}
    later = {
        "ron_320_vgg_heavy": "the 'heavy' VGG variant (ROADMAP Queue 1, left out of the realtime slice)",
        "ssd_300_vgg": "SSD (ROADMAP Queue 1 item 2)",
        "ssd_512_vgg": "SSD (ROADMAP Queue 1 item 2)",
        "ssd_300_vgg_caffe": "SSD (ROADMAP Queue 1 item 2)",
        "ssd_512_vgg_caffe": "SSD (ROADMAP Queue 1 item 2)",
    }
    if name in later:
        raise NotImplementedError(f"network {name!r} is not ported yet: {later[name]}")
    if name not in specs:
        raise ValueError(f"unknown network {name!r}; options: {sorted(specs) + sorted(later)}")
    spec = specs[name]
    return RON(spec, dtype=dtype, **kwargs), spec
