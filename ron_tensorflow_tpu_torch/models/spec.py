"""Static detector hyper-parameters.

Copied from `ron_tensorflow_tpu/models/ron.py` (`DetectorSpec`,
`RON_320_SPEC`) and `ron_tensorflow_tpu/models/testing.py`
(`RON_TINY_SPEC`), so that neither the port nor its tests need flax.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

from ..ops.anchors import AnchorLayout, build_anchor_layout


@dataclasses.dataclass(frozen=True)
class DetectorSpec:
    """Static detector hyper-parameters (ref: RONParams,
    nets/ron_vgg_320.py:72-124)."""

    name: str
    img_shape: Tuple[int, int]
    num_classes: int
    feat_layers: Tuple[str, ...]
    feat_shapes: Tuple[Tuple[int, int], ...]
    allowed_borders: Tuple[float, ...]
    anchor_sizes: Tuple[Tuple[float, ...], ...]
    anchor_ratios: Tuple[Tuple[float, ...], ...]
    anchor_steps: Tuple[float, ...]
    anchor_offset: float = 0.5
    prior_scaling: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    anchor_style: str = "ron"  # 'ron' (sizes x ratios) | 'ssd' (sizes[0]+ratios)
    normalizations: Tuple[float, ...] = ()
    has_objectness: bool = True

    @functools.lru_cache(maxsize=None)
    def anchor_layout(self) -> AnchorLayout:
        return build_anchor_layout(
            self.img_shape,
            self.feat_shapes,
            self.anchor_sizes,
            self.anchor_ratios,
            self.anchor_steps,
            self.allowed_borders,
            self.anchor_offset,
            self.anchor_style,
        )

    def num_anchors_per_cell(self, layer_idx: int) -> int:
        if self.anchor_style == "ssd":
            return len(self.anchor_sizes[layer_idx]) + len(self.anchor_ratios[layer_idx])
        return len(self.anchor_sizes[layer_idx]) * len(self.anchor_ratios[layer_idx])


RON_320_SPEC = DetectorSpec(
    name="ron_320_vgg",
    img_shape=(320, 320),
    num_classes=21,
    feat_layers=("block7", "block6", "block5", "block4"),
    feat_shapes=((5, 5), (10, 10), (20, 20), (40, 40)),
    allowed_borders=(32.0, 16.0, 8.0, 4.0),
    anchor_sizes=((224.0, 256.0), (160.0, 192.0), (96.0, 128.0), (32.0, 64.0)),
    anchor_ratios=tuple((1.0, 2.0, 3.0, 0.5, 1.0 / 3.0) for _ in range(4)),
    anchor_steps=(64.0, 32.0, 16.0, 8.0),
)

# A 64x64 RON with the same layer topology as RON-320 (block7→block4 reverse
# connections) but 1/2/4/8 grids: small enough for CPU tests.
RON_TINY_SPEC = DetectorSpec(
    name="ron_tiny_vgg",
    img_shape=(64, 64),
    num_classes=21,
    feat_layers=("block7", "block6", "block5", "block4"),
    feat_shapes=((1, 1), (2, 2), (4, 4), (8, 8)),
    allowed_borders=(32.0, 16.0, 8.0, 4.0),
    anchor_sizes=((44.8, 51.2), (32.0, 38.4), (19.2, 25.6), (6.4, 12.8)),
    anchor_ratios=tuple((1.0, 2.0, 3.0, 0.5, 1.0 / 3.0) for _ in range(4)),
    anchor_steps=(64.0, 32.0, 16.0, 8.0),
)
