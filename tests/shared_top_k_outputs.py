"""The `shared_top_k=1000` check on a trained detector's outputs: the port's
`Detector.postprocess` against the JAX package's on the same network
outputs of a crowded rehearsal checkpoint. Not a test module (it needs a
checkpoint and a card); its two steps:

    # on the card, after `tools/dress_rehearsal.py` wrote WORK (crowded):
    python3 tests/shared_top_k_outputs.py capture WORK OUT.npz [IMAGES]
    # on the CPU, where the JAX package is:
    JAX_PLATFORMS=cpu python tests/shared_top_k_outputs.py compare OUT.npz

`capture` (torch only) restores WORK's checkpoint as
`tools/ab_detection_config.py` does (bf16, the production inference mode),
runs the network on the first IMAGES (default 16) test images, and saves
the float32 `DetectorOutputs` fields that the postprocess reads, with the
card's detections under the A/B's 'presel shared_top_k=1000' config (K-A).
`compare` runs both postprocesses on the CPU under the A/B's exact config
and its 'presel shared_top_k=1000' config, prints the rows that part and
the largest score and box differences, and exits 1 if any row parts.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

FIELDS = ("predictions", "objness_pred", "locations")
MAX_BOXES = 56  # the crowded sets' gt pad (AB_MAX_BOXES)
CONFIGS = ("exact reference (no knobs)", "presel shared_top_k=1000")


def capture(work: str, out_path: str, images: int = 16, model_name: str = "ron_320_vgg", device="cuda") -> None:
    import torch

    from ron_tensorflow_tpu_torch.data.preprocess import whiten
    from ron_tensorflow_tpu_torch.inference.detector import Detector
    from ron_tensorflow_tpu_torch.models import get_network
    from ron_tensorflow_tpu_torch.tools.ab_detection_config import VARIANTS, cached_batches
    from ron_tensorflow_tpu_torch.train.checkpoint import CheckpointManager

    variables, step = CheckpointManager(os.path.join(work, "model")).restore_eval()
    model, spec = get_network(model_name, dtype=torch.bfloat16)
    model.load_state_dict({**variables["params"], **variables["batch_stats"]}, strict=True)
    det = Detector(model, spec, VARIANTS[CONFIGS[1]], device=device)
    image = np.concatenate([b["image"] for b in cached_batches(work, spec, MAX_BOXES)])[:images]
    with torch.inference_mode():
        out = det.model(whiten(torch.as_tensor(image, device=det.device).float() / 255.0))
        scores, boxes = det.postprocess(out)
    arrays = {f: getattr(out, f).float().cpu().numpy() for f in FIELDS}
    np.savez(out_path, step=step, card_scores=scores.cpu().numpy(), card_boxes=boxes.cpu().numpy(), **arrays)
    print(json.dumps({"step": step, "images": int(image.shape[0]), "kept_on_card": int((scores > 0).sum())}))


def compare(path: str) -> int:
    import jax.numpy as jnp
    import torch

    from ron_tensorflow_tpu.inference.detector import DetectionConfig as JaxDetectionConfig
    from ron_tensorflow_tpu.inference.detector import Detector as JaxDetector
    from ron_tensorflow_tpu.models.ron import RON as JaxRON
    from ron_tensorflow_tpu.models.ron import RON_320_SPEC as JAX_SPEC
    from ron_tensorflow_tpu.models.ron import DetectorOutputs as JaxDetectorOutputs

    from ron_tensorflow_tpu_torch.inference.detector import Detector
    from ron_tensorflow_tpu_torch.models import get_network
    from ron_tensorflow_tpu_torch.models.ron import DetectorOutputs
    from ron_tensorflow_tpu_torch.tools.ab_detection_config import VARIANTS

    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    model, spec = get_network("ron_320_vgg")
    out = DetectorOutputs(logits=None, objness_logits=None, **{k: torch.from_numpy(arrays[k]) for k in FIELDS})
    jout = JaxDetectorOutputs(logits=None, objness_logits=None, **{k: jnp.asarray(arrays[k]) for k in FIELDS})
    parted = 0
    report = {"step": int(arrays["step"]), "images": int(arrays["predictions"].shape[0])}
    for name in CONFIGS:
        cfg = VARIANTS[name]
        jcfg = JaxDetectionConfig(**{k: getattr(cfg, k) for k in (
            "select_threshold", "objectness_threshold", "top_k", "keep_top_k", "nms_threshold", "nms_mode",
            "min_size", "approx_top_k", "topk_chunks", "nms_method", "shared_top_k")})
        ref_s, ref_b = (np.asarray(a) for a in JaxDetector(JaxRON(spec=JAX_SPEC), JAX_SPEC, jcfg).postprocess(jout))
        with torch.inference_mode():
            got_s, got_b = (t.numpy() for t in Detector(model, spec, cfg, device="cpu").postprocess(out))
        rows = ((got_s > 0) != (ref_s > 0)).any(-1) | (np.abs(got_s - ref_s).max(-1) > 1e-5)
        parted += int(rows.sum())
        report[name] = {"rows": int(rows.size), "rows_parted": int(rows.sum()), "kept": int((ref_s > 0).sum()),
                        "max_score_diff": float(np.abs(got_s - ref_s).max()),
                        "max_box_diff": float(np.abs(got_b - ref_b).max())}
        if name == CONFIGS[1]:
            card = arrays["card_scores"]
            report[name]["card_rows_parted"] = int(((card > 0) != (ref_s > 0)).any(-1).sum())
    print(json.dumps(report))
    return 1 if parted else 0


if __name__ == "__main__":
    if sys.argv[1] == "capture":
        capture(sys.argv[2], sys.argv[3], *(int(a) for a in sys.argv[4:]))
    elif sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2]))
    else:
        raise SystemExit(__doc__)
