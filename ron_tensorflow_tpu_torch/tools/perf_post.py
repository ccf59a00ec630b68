"""Sub-stage breakdown of the detection postprocess at batch 32: decode and
gate, per-class top-k, box gather, NMS, and the whole postprocess. The port
of the JAX package's `tools/perf_post.py`.

    python -m ron_tensorflow_tpu_torch.tools.perf_post

The outputs are those of bf16 RON-320 (flax's initializers from seed 0,
`bench.seeded_network`, block 1 unfused as in the JAX tool) on standard
normal pixels at batch 32. Each stage is a function of the tensors the one
before returns (`stage_scores`, `stage_topk`, `stage_gather`, `stage_nms`),
timed by `perf_common.timeit`:

- scores+decode: `ops/decode.py`'s decode, `ops/boxes.py`'s clip and
  min-size mask, the objectness gate and the select threshold;
- exact_top_k: the per-class top-k. The JAX tool times `lax.approx_max_k`;
  the port has no approximate top-k (its `approx_top_k` selects exactly),
  so the row times and names what the port runs: `ops/math.py`'s
  `exact_top_k_chunked` at the config's `topk_chunks`;
- box gather: each class's boxes at its top-k anchors;
- fixpoint NMS: `ops/nms.py::nms_sorted_fixpoint` on every (image, class)
  row, which is K-C's keep mask (the capped scan) and its compaction;
- full postproc: `Detector.postprocess`, whose NMS is K-A on the card.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import resolve_device
from ..bench import seeded_network
from ..inference.detector import DetectionConfig, Detector
from ..ops import boxes as boxops
from ..ops import nms as nmsops
from ..ops.decode import decode_boxes
from ..ops.math import exact_top_k_chunked
from ..ops.select import masked_class_scores
from .perf_common import ITERS, WARMUP, card_line, parser, timeit

BATCH = 32


def stage_scores(out, anchors, spec, cfg: DetectionConfig):
    """-> (scores [B, C-1, N], 0 where gated or not above the select
    threshold; decoded and clipped boxes [B, N, 4])."""
    decoded = boxops.clip_to_ref(decode_boxes(out.locations, anchors, spec.prior_scaling))
    gate = out.objness_pred > cfg.objectness_threshold
    size_ok = boxops.min_size_mask(decoded, cfg.min_size)
    return masked_class_scores(out.predictions, gate & size_ok, cfg.select_threshold), decoded


def stage_topk(scores, cfg: DetectionConfig):
    """-> (top scores, anchor indices) [B, C-1, top_k], exact, ties to the lower index."""
    return exact_top_k_chunked(scores, cfg.top_k, cfg.topk_chunks)


def stage_gather(decoded, top_idx):
    """decoded [B, N, 4] at top_idx [B, C, k] -> [B, C, k, 4]."""
    b, c, k = top_idx.shape
    return torch.gather(decoded[:, None].expand(b, c, -1, 4), 2, top_idx[..., None].expand(b, c, k, 4))


def stage_nms(top_scores, top_boxes, cfg: DetectionConfig):
    """Greedy NMS of each (image, class) row -> (scores [B, C, keep_top_k],
    boxes [B, C, keep_top_k, 4]), kept in score order, zero-filled."""
    b, c, k = top_scores.shape
    s, bx = nmsops.nms_sorted_fixpoint(top_scores.reshape(b * c, k), top_boxes.reshape(b * c, k, 4),
                                       cfg.nms_threshold, cfg.keep_top_k, cfg.nms_mode)
    return s.reshape(b, c, -1), bx.reshape(b, c, -1, 4)


def run(device="cuda", model="ron_320_vgg", batch=BATCH, iters=ITERS, warmup=WARMUP) -> Dict:
    """-> {label: ms} with the JAX tool's labels but the top-k row's."""
    device = resolve_device(device)
    print(card_line(device))
    cfg = DetectionConfig()
    net, spec = seeded_network(model, torch.bfloat16)
    det = Detector(net, spec, cfg, device=device)
    img = torch.randn((batch, *spec.img_shape, 3), generator=torch.Generator().manual_seed(0)).to(device)
    rows = {}

    def row(label, fn):
        rows[label] = timeit(fn, iters=iters, warmup=warmup, device=device) * 1e3
        print(f"{label:14s}: {rows[label]:7.2f} ms", flush=True)

    with torch.inference_mode():
        out = net(img)
        anchors = det.anchors
        scores, decoded = stage_scores(out, anchors, spec, cfg)
        top_scores, top_idx = stage_topk(scores, cfg)
        top_boxes = stage_gather(decoded, top_idx)
        row("scores+decode", lambda: stage_scores(out, anchors, spec, cfg))
        row("exact_top_k", lambda: stage_topk(scores, cfg))
        row("box gather", lambda: stage_gather(decoded, top_idx))
        row("fixpoint NMS", lambda: stage_nms(top_scores, top_boxes, cfg))
        row("full postproc", lambda: det.postprocess(out))
    return rows


def main(argv=None) -> Dict:
    args = parser(__doc__).parse_args(argv)
    return run(args.device, args.model, BATCH, args.iters, args.warmup)


if __name__ == "__main__":
    main()
