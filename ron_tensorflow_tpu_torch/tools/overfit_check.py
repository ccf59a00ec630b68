"""Learning check: overfit RON-tiny on 8 synthetic images and recover their
boxes through the whole eval path.

    python3 -m ron_tensorflow_tpu_torch.tools.overfit_check [--device cuda|cpu] [--steps 400]

A port of `tools/overfit_check.py`. It closes the loop encoder -> loss ->
training -> decode -> NMS -> AP: if any of them disagreed about coordinate
order, anchor layout or gating, the mAP would collapse. The same 8 images
and gts as the JAX tool's (numpy seed 0: one or two coloured rectangles on
noise), RON-tiny initialized as flax does (seed 0), `TargetEncoder` at
0.5 / 0.3, momentum at lr 2e-3 with weight decay 1e-4, the whole batch at
every step (step i's loss draws from a generator seeded i); then the
`Detector` (top_k 64, keep_top_k 16, select threshold 0.1; on the card its
NMS is the fixpoint kernel, K-A), `match_all_classes` at 0.5 and
`StreamingTpFp`. Exits 0 only if the VOC07 mAP over the classes that have
gts is at least 0.8 (expected after ~400 steps).

Runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..inference.detector import DetectionConfig, Detector
from ..losses.ron import RonLossConfig
from ..models.ron import RON
from ..models.spec import RON_TINY_SPEC
from ..ops.ap import StreamingTpFp
from ..ops.encode import TargetEncoder
from ..ops.matching import match_all_classes
from ..train.optimizer import OptimizerConfig, make_optimizer
from ..train.state import TrainState, create_train_state, make_train_step

STEPS = 400
PASS_MAP = 0.8
SPEC = RON_TINY_SPEC
OPTIMIZER = OptimizerConfig(optimizer="momentum", learning_rate=2e-3, weight_decay=1e-4,
                            learning_rate_decay_type="fixed")
DETECTION = DetectionConfig(top_k=64, keep_top_k=16, select_threshold=0.1)


def overfit_data() -> Dict[str, np.ndarray]:
    """The 8 images (float [0, 1] and whitened, [8, 64, 64, 3]) and their
    padded gts, drawn exactly as `tools/overfit_check.py:40-62` draws them."""
    rng = np.random.default_rng(0)
    b, g = 8, 2
    images = rng.uniform(0, 0.3, (b, 64, 64, 3)).astype(np.float32)
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_labels = np.zeros((b, g), np.int32)
    gt_valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(1 + i % 2):
            cy, cx = rng.uniform(0.35, 0.65, 2)
            h, w = rng.uniform(0.3, 0.5, 2)
            y0, x0 = max(cy - h / 2, 0.0), max(cx - w / 2, 0.0)
            y1, x1 = min(cy + h / 2, 1.0), min(cx + w / 2, 1.0)
            cls = 1 + (i + j) % 3
            color = np.zeros(3)
            color[(cls - 1) % 3] = 0.9
            images[i, int(y0 * 64): int(y1 * 64), int(x0 * 64): int(x1 * 64)] = color
            gt_boxes[i, j] = [y0, x0, y1, x1]
            gt_labels[i, j] = cls
            gt_valid[i, j] = True
    whitened = images * 255.0 - np.array([123.0, 117.0, 104.0], np.float32)
    return {"image01": images, "image": whitened, "gt_boxes": gt_boxes, "gt_labels": gt_labels, "gt_valid": gt_valid}


def build(device, seed: Optional[int] = 0, optimizer: OptimizerConfig = OPTIMIZER):
    """RON-tiny on `device`, its encoder, optimizer, train state (initialized
    as flax does from `seed`; None keeps the model's weights as they are)
    and train step."""
    model = RON(SPEC).to(device)
    encoder = TargetEncoder(SPEC.anchor_layout(), SPEC.img_shape, 0.5, 0.3)
    tx = make_optimizer(optimizer, model)
    state = create_train_state(model, tx, None if seed is None else torch.Generator().manual_seed(seed))
    return model, encoder, tx, state, make_train_step(model, encoder, tx, RonLossConfig())


def device_batch(data: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(data[k], device=device) for k in ("image", "gt_labels", "gt_boxes", "gt_valid")}


def train(step: Callable, state: TrainState, batch: Dict[str, torch.Tensor], steps: int,
          draws: Optional[Callable[[int], torch.Tensor]] = None, log_every: int = 100):
    """`steps` steps on the one batch; step i's loss draws come from a
    generator seeded i, or from `draws(i)`. Returns (state, every step's
    metrics as floats)."""
    device = batch["image"].device
    history = []  # device tensors: read back at the log steps and at the end only
    t0 = time.time()
    for i in range(steps):
        gen = torch.Generator(device=device).manual_seed(i)
        state, metrics = step(state, batch, gen, None if draws is None else draws(i))
        history.append(metrics)
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}: loss {float(metrics['loss/total']):.4f} ({time.time() - t0:.0f}s)", flush=True)
    return state, [{k: float(v) for k, v in m.items()} for m in history]


def evaluate(model, batch: Dict[str, torch.Tensor], device):
    """The Detector on the training images, matched at 0.5 -> (VOC07 mAP over
    all 20 classes, {class: AP07} of the classes that have gts)."""
    scores, boxes = Detector(model, SPEC, DETECTION, device=device)(batch["image"])
    labels = batch["gt_labels"].to(scores.device)
    res = match_all_classes(SPEC.num_classes, scores, boxes, labels, batch["gt_boxes"].to(scores.device),
                            torch.zeros_like(labels, dtype=torch.bool), 0.5)
    n_gt, scores_np, tp, fp = (t.cpu().numpy() for t in (res.n_gt, scores, res.tp, res.fp))
    acc = StreamingTpFp(SPEC.num_classes)
    for img in range(scores_np.shape[0]):
        for c in range(1, SPEC.num_classes):
            acc.add(c, n_gt[img, c - 1], scores_np[img, c - 1], tp[img, c - 1], fp[img, c - 1])
    m07, aps = acc.mean_average_precision("voc07")
    return m07, {c: ap for c, ap in aps.items() if acc.n_gt[c] > 0}


def run(device="cuda", steps: int = STEPS) -> Dict:
    """The whole check; returns its numbers (mAP over the classes with gts
    under "map", "passed")."""
    device = resolve_device(device)
    data = overfit_data()
    batch = device_batch(data, device)
    model, _, _, state, step = build(device)
    t0 = time.time()
    state, history = train(step, state, batch, steps)
    train_s = time.time() - t0
    m07, used = evaluate(model, batch, device)
    mean_used = float(np.mean(list(used.values())))
    print("per-class AP:", {c: round(v, 3) for c, v in used.items()})
    print(f"overfit mAP(voc07) = {m07:.4f} over classes with gt: {mean_used:.4f}")
    passed = mean_used >= PASS_MAP
    print("OVERFIT CHECK:", "PASS" if passed else "FAIL")
    return {"map": mean_used, "map_all_classes": m07, "aps": used, "steps": steps, "train_s": train_s,
            "seconds": time.time() - t0, "losses": [h["loss/total"] for h in history], "passed": passed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda; cpu only when asked for)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    return 0 if run(args.device, args.steps)["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
