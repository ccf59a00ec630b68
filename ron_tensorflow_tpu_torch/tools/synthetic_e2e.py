"""Learning check through the production path on a synthetic detection
dataset, scored on a held-out split.

    python3 -m ron_tensorflow_tpu_torch.tools.synthetic_e2e [--device cuda|cpu] [--work-dir DIR]

A port of `tools/synthetic_e2e.py`. It writes the 6-class shapes dataset
(`tools/synthetic_data.py`: 800 training and 96 test images) as TFRecord
shards, trains through the real `Trainer` (records -> host pipeline ->
augmentation on the device -> train step -> checkpoints), then scores the
test split with a bf16 model and the `StreamingEvaluator`. The test split
is disjoint from the training one, so a good mAP shows generalization
through the whole stack. Exits 0 only if the held-out VOC07 mAP over
classes 1-6 is at least 0.6.

The JAX tool's environment variables and defaults: SYNTH_MODEL
(ron_tiny_vgg), SYNTH_CANVAS (128), SYNTH_BATCH (32), SYNTH_BF16 (false),
SYNTH_STEPS (1500), SYNTH_LR (0.003), SYNTH_WARMUP (0), SYNTH_CLIP (0),
SYNTH_BN_FAST (false), SYNTH_FUSE_BLOCK1 (false). The full-width recipe:

    SYNTH_MODEL=ron_320_vgg SYNTH_CANVAS=400 SYNTH_BF16=true SYNTH_STEPS=2500 \\
        SYNTH_FUSE_BLOCK1=true python3 -m ron_tensorflow_tpu_torch.tools.synthetic_e2e

On the card, training with SYNTH_FUSE_BLOCK1=true and bf16 runs block 1
through the fused kernel (K-B); the evaluator always runs it there, with
the fixpoint NMS kernel (K-A). Runs on the card unless given `--device cpu`.
Without `--work-dir` the records and checkpoints go to a new temporary
directory, which is kept.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Mapping

import numpy as np
import torch

from .. import resolve_device
from ..cli import fuse_block1_for_eval
from ..config import TrainConfig, apply_overrides
from ..data.pipeline import PipelineConfig, batch_iterator
from ..data.preprocess import whiten_np
from ..eval import StreamingEvaluator
from ..inference.detector import DetectionConfig
from ..models import get_network, get_spec
from ..train.trainer import Trainer
from .synthetic_data import make_dataset

PASS_MAP = 0.6
DEFAULTS = {"MODEL": "ron_tiny_vgg", "CANVAS": "128", "BATCH": "32", "BF16": "false", "STEPS": "1500",
            "LR": "0.003", "WARMUP": "0", "CLIP": "0", "BN_FAST": "false", "FUSE_BLOCK1": "false"}


def settings(env: Mapping[str, str] = os.environ) -> Dict[str, str]:
    """The SYNTH_* variables of `env`, with the JAX tool's defaults."""
    return {k: env.get(f"SYNTH_{k}", v) for k, v in DEFAULTS.items()}


def train_config(s: Dict[str, str], data_dir: str, model_dir: str) -> TrainConfig:
    """The JAX tool's TrainConfig (`tools/synthetic_e2e.py:90-116`)."""
    steps = int(s["STEPS"])
    cfg = apply_overrides(
        TrainConfig(),
        [
            f"model={s['MODEL']}",
            f"model_dir={model_dir}",
            f"data.dataset_dir={data_dir}",
            "data.file_pattern=synth_train_*.tfrecord",
            f"data.batch_size={int(s['BATCH'])}",
            "data.max_boxes=8",
            f"max_steps={steps}",
            "log_every_steps=100",
            "save_every_steps=1000",
            f"optimizer.learning_rate={s['LR']}",
            f"optimizer.warmup_steps={s['WARMUP']}",
            f"optimizer.clip_global_norm={s['CLIP']}",
            "optimizer.learning_rate_decay_type=piecewise",
            f"optimizer.lr_boundaries=[{int(steps * 0.6)}, {int(steps * 0.85)}]",
            "optimizer.lr_factors=[1.0, 0.1, 0.01]",
            "match.positive_threshold=0.5",
            "mesh_shape=[1, 1]",
            f"bfloat16={s['BF16']}",
            f"bn_fast_normalize={s['BN_FAST']}",
            f"fuse_block1={s['FUSE_BLOCK1']}",
        ],
    )
    canvas = int(s["CANVAS"])
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, working_shape=(canvas, canvas)))


def train(s: Dict[str, str], data_dir: str, work: str, device) -> Trainer:
    """The Trainer of `train_config`, trained; its model holds the weights."""
    trainer = Trainer(train_config(s, data_dir, os.path.join(work, "model")), device=device)
    trainer.train()
    return trainer


def detection_config(model_name: str) -> DetectionConfig:
    tiny = model_name == "ron_tiny_vgg"
    return DetectionConfig(top_k=64 if tiny else 200, keep_top_k=16 if tiny else 100, select_threshold=0.05,
                           objectness_threshold=0.03)


def evaluate(s: Dict[str, str], weights: Dict[str, torch.Tensor], data_dir: str, device) -> Dict:
    """The held-out split through a bf16 model with `weights` (a state dict)
    and the `StreamingEvaluator` -> its numbers ("map": the mean AP07 over
    classes 1-6)."""
    device = resolve_device(device)
    spec = get_spec(s["MODEL"])
    model, spec = get_network(s["MODEL"], dtype=torch.bfloat16, fuse_block1=fuse_block1_for_eval(spec, device, True))
    model.load_state_dict(weights, strict=True)
    ev = StreamingEvaluator(model, spec, detection_config(s["MODEL"]), device=device)
    pcfg = PipelineConfig(batch_size=8, working_shape=spec.img_shape, max_boxes=8, shuffle=False, keep_difficult=True)
    test_files = [os.path.join(data_dir, "synth_test_000.tfrecord")]

    def eval_batches():
        for hb in batch_iterator(test_files, pcfg, epochs=1, drop_remainder=False):
            yield {"image": whiten_np(hb["image01"]), "gt_labels": hb["gt_labels"], "gt_boxes": hb["gt_boxes"],
                   "gt_difficult": hb["gt_difficult"], "sample_valid": hb["sample_valid"]}

    map07, map12, aps, _ = ev.run(eval_batches(), log_every=0)
    used = {c: v for c, v in aps.items() if c <= 6}
    return {"map": float(np.mean(list(used.values()))), "map07_all_classes": map07, "map12_all_classes": map12,
            "aps": used}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda; cpu only when asked for)")
    ap.add_argument("--work-dir", default=None, help="records and checkpoints (default: a new temporary directory)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    s = settings()
    work = args.work_dir or tempfile.mkdtemp(prefix="synth_e2e_")
    t0 = time.time()
    data_dir = make_dataset(os.path.join(work, "records"), canvas=int(s["CANVAS"]))
    print(f"dataset at {data_dir} (canvas {s['CANVAS']}, model {s['MODEL']}) in {time.time() - t0:.1f} s")
    trainer = train(s, data_dir, work, device)
    res = evaluate(s, trainer.model.state_dict(), data_dir, device)
    print("held-out per-class AP07:", {c: round(v, 3) for c, v in res["aps"].items()})
    print(f"held-out mAP07 (classes 1-6) = {res['map']:.4f}  (all-21-class mAP {res['map07_all_classes']:.4f}, "
          f"mAP12 {res['map12_all_classes']:.4f})")
    ok = res["map"] >= PASS_MAP
    print("SYNTHETIC E2E:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
