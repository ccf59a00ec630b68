"""Held-out mAP of a trained rehearsal checkpoint under nine
`DetectionConfig` variants: whether the detection speed knobs
(`shared_top_k` preselection, `approx_top_k`, the NMS method) change
detection quality.

    python3 -m ron_tensorflow_tpu_torch.tools.ab_detection_config [--device cuda|cpu] WORK [MODEL]

A port of `tools/ab_detection_config.py`. WORK is a dress rehearsal's (or
a synthetic check's) work dir: its newest checkpoint under WORK/model and
its test records under WORK/records. MODEL defaults to SYNTH_MODEL, else
ron_320_vgg. AB_MAX_BOXES (8) is the gt pad: a crowded rehearsal needs 56,
or the gt tables are cut short and recall is wrong. The test split is
decoded once into uint8 batches (whitened on the device by the evaluator)
and scored by the bf16 `StreamingEvaluator` under each variant: six speed
knobs that must not move the mAP and three semantic points (union mode,
NMS thresholds 0.45 and 0.30) that may. One line a variant, then the
verdict on the speed knobs (mAP07 within 1e-6 of the exact run).

On the card the NMS method picks the kernel (`inference/detector.py`):
'loop' and 'fixpoint' run K-C (dividing predicate), 'pallas' and 'auto'
run K-A (division-free); on the CPU 'auto' runs K-C's plain version. So
the A/B also compares the two predicates on trained detections: on the
exact run's rows, the rows and boxes where K-A's keep set (cut at
keep_top_k) parts from K-C's are counted and printed. The last line is
one JSON object: each variant's mAP07 and that count.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, List

import numpy as np
import torch

from .. import kernels, resolve_device
from ..data.pipeline import PipelineConfig, batch_iterator
from ..data.preprocess import whiten
from ..eval import StreamingEvaluator
from ..inference.detector import DetectionConfig, Detector
from ..models import get_network
from ..train.checkpoint import CheckpointManager
from .dress_rehearsal import eval_record_files

LOSSLESS_TOL = 1e-6
BASE = DetectionConfig(select_threshold=0.05, objectness_threshold=0.03)
# speed knobs (must be mAP-lossless) x NMS mode and threshold points (these
# change the semantics: reported, not held equal)
VARIANTS = {
    "exact reference (no knobs)": dataclasses.replace(BASE, shared_top_k=0, approx_top_k=False, nms_method="loop"),
    "approx_top_k only": dataclasses.replace(BASE, approx_top_k=True, shared_top_k=0, nms_method="loop"),
    "presel shared_top_k=1000": dataclasses.replace(BASE, shared_top_k=1000),
    "presel + pallas NMS": dataclasses.replace(BASE, shared_top_k=1000, nms_method="pallas"),
    "pallas NMS": dataclasses.replace(BASE, nms_method="pallas"),
    "fixpoint NMS": dataclasses.replace(BASE, nms_method="fixpoint"),
    "nms mode=union (semantic)": dataclasses.replace(BASE, nms_mode="union"),
    "nms thresh=0.45 (semantic)": dataclasses.replace(BASE, nms_threshold=0.45),
    "nms thresh=0.30 (semantic)": dataclasses.replace(BASE, nms_threshold=0.30),
}
EXACT = "exact reference (no knobs)"


def cached_batches(work: str, spec, max_boxes: int) -> List[Dict[str, np.ndarray]]:
    """The test split as uint8 batches of 8 (the train path's resize), decoded once."""
    pcfg = PipelineConfig(batch_size=8, working_shape=spec.img_shape, max_boxes=max_boxes, shuffle=False,
                          keep_difficult=True, output_dtype="uint8")
    return [{k: hb[k] for k in ("gt_labels", "gt_boxes", "gt_difficult", "sample_valid")} | {"image": hb["image01"]}
            for hb in batch_iterator(eval_record_files(os.path.join(work, "records")), pcfg, epochs=1,
                                     drop_remainder=False)]


@torch.inference_mode()
def keep_set_parting(model, spec, batches, device) -> Dict[str, int]:
    """On the exact variant's NMS rows (per image and class, score sorted),
    K-A's keep mask cut to its first keep_top_k kept against K-C's capped
    one: the rows whose keep sets differ and the boxes kept by one only."""
    cfg = VARIANTS[EXACT]
    det = Detector(model, spec, cfg, device=device)
    rows = parted_rows = parted_boxes = 0
    for batch in batches:
        image = torch.as_tensor(batch["image"]).to(det.device)
        flat_s, flat_b = det.candidates(det.model(whiten(image.to(torch.float32) / 255.0)))
        flat_s, flat_b = flat_s.contiguous(), flat_b.contiguous()
        valid = torch.as_tensor(np.asarray(batch["sample_valid"]), device=det.device)
        valid = valid.repeat_interleave(flat_s.shape[0] // valid.shape[0])
        keep_a = kernels.nms_fixpoint_keep_mask(flat_s, flat_b, cfg.nms_threshold, cfg.nms_mode)
        keep_a &= torch.cumsum(keep_a.to(torch.int32), dim=-1) <= cfg.keep_top_k
        keep_c = kernels.nms_scan_keep_mask(flat_s, flat_b, cfg.nms_threshold, cfg.keep_top_k, cfg.nms_mode)
        differ = (keep_a != keep_c) & valid[:, None]
        rows += int(valid.sum())
        parted_rows += int(differ.any(dim=-1).sum())
        parted_boxes += int(differ.sum())
    return {"rows": rows, "rows_parted": parted_rows, "boxes_parted": parted_boxes}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda; cpu only when asked for)")
    ap.add_argument("work", help="a rehearsal's work dir (model/ and records/)")
    ap.add_argument("model", nargs="?", default=os.environ.get("SYNTH_MODEL", "ron_320_vgg"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    variables, step = CheckpointManager(os.path.join(args.work, "model")).restore_eval()
    model, spec = get_network(args.model, dtype=torch.bfloat16)  # production inference mode
    model.load_state_dict({**variables["params"], **variables["batch_stats"]}, strict=True)
    print(f"[ab] {args.model} @ step {step}")
    batches = cached_batches(args.work, spec, int(os.environ.get("AB_MAX_BOXES", "8")))

    results = {}
    for name, cfg in VARIANTS.items():
        ev = StreamingEvaluator(model, spec, cfg, device=device)
        map07, map12, aps, _ = ev.run(iter(batches), log_every=0)
        present = [v for v in aps.values() if v >= 0]
        results[name] = map07
        print(f"{name:28s}: mAP07 {map07:.4f}  mAP12 {map12:.4f}  mean-present-AP07 {np.mean(present):.4f}")
    exact = results[EXACT]
    lossless = [n for n in results if "semantic" not in n]
    bad = {n: results[n] for n in lossless if abs(results[n] - exact) > LOSSLESS_TOL}
    if bad:
        print(f"LOSSLESS-KNOB MISMATCH vs exact ({exact:.4f}): {bad}")
    else:
        print(f"all speed knobs lossless (mAP07 {exact:.4f})")
    parting = keep_set_parting(model, spec, batches, device)
    print(f"K-A vs K-C keep sets on the exact run's rows: {parting['rows_parted']} of {parting['rows']} rows, "
          f"{parting['boxes_parted']} boxes part")
    out = {"model": args.model, "step": step, "map07": results, "lossless": not bad, "keep_set_parting": parting}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
