"""Static detector hyper-parameters.

Copied from `ron_tensorflow_tpu/models/ron.py` (`DetectorSpec`,
`RON_320_SPEC`), `ron_tensorflow_tpu/models/testing.py` (`RON_TINY_SPEC`)
and `ron_tensorflow_tpu/models/ssd.py` (`SSD_300_SPEC`, `SSD_512_SPEC`), so
that neither the port nor its tests need flax.
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
    # per-layer L2-normalization scale init; <= 0 disables (SSD's block4: 20)
    normalizations: Tuple[float, ...] = ()
    # False for SSD, whose outputs carry a constant objectness of 1: heads
    # gated by objectness pick class-wise semantics (RealtimeConfig.for_spec)
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

SSD_300_SPEC = DetectorSpec(
    name="ssd_300_vgg",
    img_shape=(300, 300),
    num_classes=21,
    feat_layers=("block4", "block7", "block8", "block9", "block10", "block11"),
    feat_shapes=((38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)),
    # SSD matches without border filtering; borders = img size disable it.
    allowed_borders=(300.0,) * 6,
    anchor_sizes=((21.0, 45.0), (45.0, 99.0), (99.0, 153.0), (153.0, 207.0), (207.0, 261.0), (261.0, 315.0)),
    anchor_ratios=(
        (2.0, 0.5),
        (2.0, 0.5, 3.0, 1.0 / 3.0),
        (2.0, 0.5, 3.0, 1.0 / 3.0),
        (2.0, 0.5, 3.0, 1.0 / 3.0),
        (2.0, 0.5),
        (2.0, 0.5),
    ),
    anchor_steps=(8.0, 16.0, 32.0, 64.0, 100.0, 300.0),
    anchor_style="ssd",
    normalizations=(20.0, -1.0, -1.0, -1.0, -1.0, -1.0),
    has_objectness=False,
)

SSD_512_SPEC = DetectorSpec(
    name="ssd_512_vgg",
    img_shape=(512, 512),
    num_classes=21,
    feat_layers=("block4", "block7", "block8", "block9", "block10", "block11", "block12"),
    feat_shapes=((64, 64), (32, 32), (16, 16), (8, 8), (4, 4), (2, 2), (1, 1)),
    allowed_borders=(512.0,) * 7,
    anchor_sizes=(
        (20.48, 51.2),
        (51.2, 133.12),
        (133.12, 215.04),
        (215.04, 296.96),
        (296.96, 378.88),
        (378.88, 460.8),
        (460.8, 542.72),
    ),
    anchor_ratios=(
        (2.0, 0.5),
        (2.0, 0.5, 3.0, 1.0 / 3.0),
        (2.0, 0.5, 3.0, 1.0 / 3.0),
        (2.0, 0.5, 3.0, 1.0 / 3.0),
        (2.0, 0.5, 3.0, 1.0 / 3.0),
        (2.0, 0.5),
        (2.0, 0.5),
    ),
    anchor_steps=(8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0),
    anchor_style="ssd",
    normalizations=(20.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0),
    has_objectness=False,
)
