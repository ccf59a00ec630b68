"""VOC-scale dress rehearsal of the published recipe on a 21-class
synthetic shapes dataset, scored by both evaluators.

    python3 -m ron_tensorflow_tpu_torch.tools.dress_rehearsal [--device cuda|cpu] [WORK]

A port of `tools/dress_rehearsal.py`. It draws a 21-class shapes dataset
(default 10 000 training and 1 000 test images, each side 320-499 px, 1-4
objects an image, ~10% of them `difficult`) and writes it in both layouts
from the same samples: TFRecord shards of 2000 under WORK/records (the
streaming evaluator's input) and a VOCdevkit tree under WORK/VOCdevkit
(the realtime evaluator's, with the official VOC protocol). Class k is
(shape, colour) combination k: rect, ellipse, triangle, bar and ring in
four colours. It then trains the published recipe through the `Trainer`
(batch 14, momentum 0.9, lr 1e-3 piecewise x{1, 0.1, 0.001} at 75% and
95.8% of the steps, warmup, global-norm clip, match 0.56, bf16, warm
started from a seeded torchvision-layout VGG-16 `state_dict`), restores
the newest checkpoint with `CheckpointManager.restore_eval` and scores it
twice: the bf16 `StreamingEvaluator` (select 0.01, objectness 0.03,
top_k 200, keep_top_k 100, shared_top_k 1000) on the records, and
`RealtimeEvaluator.evaluate_voc` (`RealtimeConfig.for_spec`, objectness
gate DR_OBJ_THRESH) on the VOCdevkit tree. WORK/result.json holds the two
mAPs and their gap; exit 0 only if the streaming VOC07 mAP is at least
0.5 and the two evaluators differ by at most 0.06. Each run's record,
with its `ok`, also goes into WORK/rehearsal.json (one entry per model
and crowding).

The random draws come in the JAX tool's order, so the same seed gives the
same image sizes, boxes, labels and `difficult` flags. The shapes are
`tools/synthetic_data.py`'s numpy counterparts of Pillow's `ImageDraw`, and
the images are JPEG-encoded at quality 90 by `data/jpeg.py::encode_jpeg`
(no PIL, no cv2).

Environment (the JAX tool's names and defaults):
  DR_MODEL  ron_320_vgg (default) | ron_320_vgg_heavy | ssd_300_vgg | ssd_512_vgg
  DR_STEPS  total steps (20000); the schedule's boundaries scale with it
  DR_TRAIN / DR_TEST  dataset sizes (10000 / 1000)
  DR_BATCH  batch size (14)
  DR_CROWDED=1  1-48 objects an image (mean ~8), same-class clusters, tiny
    objects, and objects mostly covered by later draws marked difficult;
    the gt pad (max_boxes) rises from 8 to 56 in training and evaluation
  DR_OBJ_THRESH  the realtime objectness gate (0.95)
  DR_LR / DR_WARMUP / DR_CLIP  recipe overrides (per model: RON lr 1e-3,
    warmup 500, clip 50; SSD-300 3e-3, 1000, 50; SSD-512 1e-3, 2000, 25)
  DR_SKIP_TRAIN=1  score the work dir's checkpoint without training

Runs on the card unless given `--device cpu`. Without WORK the run goes to
dress_<model>[_crowded] in the temporary directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, Mapping

import numpy as np
import torch

from .. import resolve_device
from ..config import TrainConfig, apply_overrides
from ..data.convert import encode_voc_example
from ..data.jpeg import encode_jpeg
from ..data.pipeline import PipelineConfig, PrefetchIterator, batch_iterator
from ..data.preprocess import whiten_np
from ..data.tfrecord import TFRecordWriter
from ..data.voc import VOC_CLASSES, VocAnnotation, VocObject
from ..eval import StreamingEvaluator
from ..eval.realtime import RealtimeEvaluator
from ..inference.detector import DetectionConfig, RealtimeConfig
from ..models import get_network, get_spec
from ..train.checkpoint import CheckpointManager
from ..train.trainer import Trainer
from .synthetic_data import fill_ellipse, fill_polygon, fill_rectangle

# The 20 VOC class names keep the VOCdevkit evaluator's name -> index map;
# class k's appearance is (shape, colour) combination k.
SHAPES = ("rect", "ellipse", "triangle", "bar", "ring")
COLORS = ((235, 45, 45), (45, 235, 45), (65, 65, 245), (235, 235, 45))
RING_HOLE = (40, 40, 40)
PER_SHARD = 2000
PASS_MAP = 0.5
MAX_DELTA = 0.06
DEFAULTS = {"MODEL": "ron_320_vgg", "STEPS": "20000", "BATCH": "14", "TRAIN": "10000", "TEST": "1000",
            "CROWDED": "0", "OBJ_THRESH": "0.95"}
RESULT_KEYS = ("model", "crowded", "steps", "map07_streaming", "map12_streaming", "map07_realtime", "delta",
               "streaming_ms_per_img", "realtime_ms_per_img")
# the streaming evaluator's config (`tools/dress_rehearsal.py:358-362`)
STREAMING = DetectionConfig(select_threshold=0.01, objectness_threshold=0.03, top_k=200, keep_top_k=100,
                            shared_top_k=1000)


def draw_object(img: np.ndarray, cls: int, box) -> None:
    """Class `cls` (1..20) in `box` (x0, y0, x1, y1) on an [H, W, 3] array."""
    shape = SHAPES[(cls - 1) % 5]
    color = COLORS[(cls - 1) // 5]
    x0, y0, x1, y1 = box
    if shape == "rect":
        fill_rectangle(img, box, color)
    elif shape == "ellipse":
        fill_ellipse(img, box, color)
    elif shape == "triangle":
        fill_polygon(img, [(x0, y1), (x1, y1), ((x0 + x1) / 2, y0)], color)
    elif shape == "bar":
        h = y1 - y0
        fill_rectangle(img, (x0, y0 + 0.35 * h, x1, y1 - 0.35 * h), color)
    else:  # ring
        fill_ellipse(img, box, color)
        w, h = x1 - x0, y1 - y0
        fill_ellipse(img, (x0 + 0.3 * w, y0 + 0.3 * h, x1 - 0.3 * w, y1 - 0.3 * h), RING_HOLE)


def _object(cls, x0, y0, ow, oh, h, w, difficult) -> VocObject:
    return VocObject(label=cls, label_text=VOC_CLASSES[cls - 1], bbox=(y0 / h, x0 / w, (y0 + oh) / h, (x0 + ow) / w),
                     difficult=difficult, truncated=0)


def mark_covered(objects):
    """Crowded scenes: objects that later draws cover to more than 70%,
    on a 128x128 z-order raster of the boxes, become difficult (VOC: left
    out of AP), as an occluded gt cannot be found from pixels."""
    own = np.full((128, 128), -1, np.int32)
    cells = []
    for k, o in enumerate(objects):
        ymin, xmin, ymax, xmax = o.bbox
        r0, r1 = int(ymin * 128), max(int(ymin * 128) + 1, int(ymax * 128))
        c0, c1 = int(xmin * 128), max(int(xmin * 128) + 1, int(xmax * 128))
        own[r0:r1, c0:c1] = k
        cells.append((r0, r1, c0, c1))
    for k, (o, (r0, r1, c0, c1)) in enumerate(zip(objects, cells)):
        area = (r1 - r0) * (c1 - c0)
        visible = int((own[r0:r1, c0:c1] == k).sum())
        if area > 0 and visible / area < 0.3:
            objects[k] = dataclasses.replace(o, difficult=1)


def gen_sample(rng: np.random.Generator, crowded: bool):
    """One image -> (JPEG bytes, (h, w), [VocObject]), drawing from `rng`
    in `tools/dress_rehearsal.py::gen_sample`'s order."""

    def n_objects():
        if not crowded:
            return 1 + int(rng.integers(0, 4))
        # long tail: 55% sparse (1-5), 35% medium (6-18), 10% crowd (19-48)
        u = rng.uniform()
        if u < 0.55:
            return 1 + int(rng.integers(0, 5))
        if u < 0.90:
            return 6 + int(rng.integers(0, 13))
        return 19 + int(rng.integers(0, 30))

    h = int(rng.integers(320, 500))
    w = int(rng.integers(320, 500))
    img = (rng.integers(0, 70, (h, w, 3)) + rng.integers(0, 40)).astype(np.uint8)
    objects = []
    n = n_objects()
    lo_frac = 0.04 if crowded else 0.12  # crowded scenes get tiny objects
    i = 0
    while i < n:
        cls = 1 + int(rng.integers(0, 20))
        if crowded and n - i >= 3 and rng.uniform() < 0.35:
            # an overlapping same-class cluster
            k = min(3 + int(rng.integers(0, 3)), n - i)
            s = rng.uniform(0.08, 0.22)
            cyc = rng.uniform(s, 1 - s)
            cxc = rng.uniform(s, 1 - s)
            for _ in range(k):
                ow = s * rng.uniform(0.8, 1.2) * w
                oh = s * rng.uniform(0.8, 1.2) * h
                x0 = np.clip(cxc * w + rng.uniform(-0.6, 0.6) * ow - ow / 2, 0, w - ow)
                y0 = np.clip(cyc * h + rng.uniform(-0.6, 0.6) * oh - oh / 2, 0, h - oh)
                draw_object(img, cls, (x0, y0, x0 + ow, y0 + oh))
                difficult = int(min(ow / w, oh / h) < 0.08 and rng.uniform() < 0.5)
                objects.append(_object(cls, x0, y0, ow, oh, h, w, difficult))
                i += 1
            continue
        ow = rng.uniform(lo_frac, 0.5) * w
        oh = rng.uniform(lo_frac, 0.5) * h
        x0 = rng.uniform(0, w - ow)
        y0 = rng.uniform(0, h - oh)
        draw_object(img, cls, (x0, y0, x0 + ow, y0 + oh))
        # small objects are difficult (left out of AP, as in VOC)
        thr = 0.08 if crowded else 0.15
        difficult = int(min(ow / w, oh / h) < thr and rng.uniform() < 0.5)
        objects.append(_object(cls, x0, y0, ow, oh, h, w, difficult))
        i += 1
    if crowded and len(objects) > 1:
        mark_covered(objects)
    return encode_jpeg(img, quality=90), (h, w), objects


def ann_xml(hw, objects) -> str:
    """The VOC annotation XML of one image, as the JAX tool writes it."""
    h, w = hw
    parts = [f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth></size>"]
    for o in objects:
        ymin, xmin, ymax, xmax = o.bbox
        parts.append(
            f"<object><name>{o.label_text}</name><difficult>{o.difficult}</difficult>"
            f"<truncated>0</truncated><bndbox>"
            f"<xmin>{xmin * w:.1f}</xmin><ymin>{ymin * h:.1f}</ymin>"
            f"<xmax>{xmax * w:.1f}</xmax><ymax>{ymax * h:.1f}</ymax>"
            f"</bndbox></object>"
        )
    parts.append("</annotation>")
    return "".join(parts)


def make_dataset(out_root: str, n_train=10000, n_test=1000, seed=0, crowded=False):
    """Write records/ (TFRecord shards of PER_SHARD) and VOCdevkit/VOC2007
    (JPEGs, XML, ImageSets/Main/test.txt) from the same samples ->
    (records dir, VOCdevkit root)."""
    rng = np.random.default_rng(seed)
    rec_dir = os.path.join(out_root, "records")
    voc_dir = os.path.join(out_root, "VOCdevkit", "VOC2007")
    os.makedirs(rec_dir, exist_ok=True)
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc_dir, sub), exist_ok=True)
    t0 = time.time()
    test_ids = []
    for split, n in (("train", n_train), ("test", n_test)):
        writer, wi = None, -1
        for i in range(n):
            if i // PER_SHARD != wi:
                if writer:
                    writer.close()
                wi = i // PER_SHARD
                writer = TFRecordWriter(os.path.join(rec_dir, f"synth_{split}_{wi:03d}.tfrecord"))
            jpeg, hw, objects = gen_sample(rng, crowded)
            writer.write(encode_voc_example(jpeg, VocAnnotation((hw[0], hw[1], 3), objects)))
            if split == "test":
                image_id = f"{i:06d}"
                test_ids.append(image_id)
                with open(os.path.join(voc_dir, "JPEGImages", image_id + ".jpg"), "wb") as f:
                    f.write(jpeg)
                with open(os.path.join(voc_dir, "Annotations", image_id + ".xml"), "w") as f:
                    f.write(ann_xml(hw, objects))
        if writer:
            writer.close()
        print(f"[data] {split}: {n} samples ({time.time() - t0:.0f}s)")
    with open(os.path.join(voc_dir, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(test_ids) + "\n")
    return rec_dir, os.path.join(out_root, "VOCdevkit")


def make_torch_vgg_checkpoint(path: str, seed: int = 0) -> str:
    """A seeded torchvision-layout VGG-16 `state_dict` (He-scaled normal
    kernels, zero biases) at `path`: the warm start goes through the real
    torch importer, with random weights in place of pretrained ones."""
    gen = torch.Generator().manual_seed(seed)
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
    sd, idx, cin = {}, 0, 3
    for v in cfg:
        if v == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.randn((v, cin, 3, 3), generator=gen) * (2.0 / (9 * cin)) ** 0.5
        sd[f"features.{idx}.bias"] = torch.zeros((v,))
        cin = v
        idx += 2
    torch.save(sd, path)
    return path


def settings(env: Mapping[str, str] = os.environ) -> Dict[str, str]:
    """The DR_* variables of `env`, with the JAX tool's defaults."""
    return {k: env.get(f"DR_{k}", v) for k, v in DEFAULTS.items()}


def max_boxes(crowded: bool) -> int:
    """Crowded scenes need the full 56-gt pad; sparse ones keep 8."""
    return 56 if crowded else 8


def train_config(model_name: str, work: str, steps: int, batch: int, crowded: bool, ckpt: str,
                 env: Mapping[str, str] = os.environ) -> TrainConfig:
    """The JAX tool's TrainConfig (`tools/dress_rehearsal.py:292-339`). From
    scratch, SSD needs warmup and clipping, and its recipe depends on the
    size: SSD-300 takes lr 3e-3 with warmup 1000, SSD-512 at batch 14
    collapses to all-background at that lr and takes 1e-3 with warmup 2000."""
    spec = get_spec(model_name)
    is_ssd = model_name.startswith("ssd")
    is_512 = spec.img_shape[0] > 400
    lr = float(env.get("DR_LR", "0.001" if (not is_ssd or is_512) else "0.003"))
    warmup = int(env.get("DR_WARMUP", "2000" if is_512 else ("1000" if is_ssd else "500")))
    cfg = apply_overrides(
        TrainConfig(),
        [
            f"model={model_name}",
            f"model_dir={work}/model",
            f"data.dataset_dir={os.path.join(work, 'records')}",
            "data.file_pattern=synth_train_*.tfrecord",
            f"data.batch_size={batch}",
            f"data.max_boxes={max_boxes(crowded)}",
            "data.cache_decoded=true",
            f"max_steps={steps}",
            "log_every_steps=100",
            "save_every_steps=5000",
            # the published recipe (ref: ron_net.py:95-105, 152-155)
            f"optimizer.learning_rate={lr}",
            "optimizer.momentum=0.9",
            "optimizer.learning_rate_decay_type=piecewise",
            f"optimizer.lr_boundaries=[{int(steps * 0.75)}, {int(steps * 0.958)}]",
            "optimizer.lr_factors=[1.0, 0.1, 0.001]",
            f"optimizer.warmup_steps={warmup}",
            f"optimizer.clip_global_norm={env.get('DR_CLIP', '25.0' if is_512 else '50.0')}",
            "match.positive_threshold=0.56",
            f"checkpoint_path={ckpt}",
            "checkpoint_format=torch",
            "mesh_shape=[1, 1]",
            "bfloat16=true",
            "max_host_rss_gb=95",
        ],
    )
    # a working canvas above the model input, so that crops do not upsample
    canvas = 520 if is_512 else 400
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, working_shape=(canvas, canvas)))


def eval_record_files(rec_dir: str):
    return sorted(os.path.join(rec_dir, f) for f in os.listdir(rec_dir) if "test" in f)


def streaming_eval(model, spec, rec_dir: str, crowded: bool, device):
    """The test records through the `StreamingEvaluator` with the eval
    resize's numerics -> (map07, map12, {class: ap07}, stats)."""
    ev = StreamingEvaluator(model, spec, STREAMING, device=device)
    pcfg = PipelineConfig(batch_size=8, working_shape=spec.img_shape, max_boxes=max_boxes(crowded), shuffle=False,
                          keep_difficult=True, eval_resize="WARP_RESIZE")

    def eval_batches():
        for hb in PrefetchIterator(batch_iterator(eval_record_files(rec_dir), pcfg, epochs=1, drop_remainder=False)):
            image = hb["image01"]
            yield {"image": whiten_np(image.astype(np.float32) / 255.0 if image.dtype == np.uint8 else image),
                   "gt_labels": hb["gt_labels"], "gt_boxes": hb["gt_boxes"], "gt_difficult": hb["gt_difficult"],
                   "sample_valid": hb["sample_valid"]}

    return ev.run(eval_batches(), log_every=0)


def realtime_eval(model, spec, voc_root: str, objectness_threshold: float, output_dir: str, device):
    """The VOCdevkit tree through `RealtimeEvaluator.evaluate_voc`: RON with
    the published ron_eval.py flags (objectness gate 0.95), SSD class-wise
    (`RealtimeConfig.for_spec`) -> (mAP, {class: AP})."""
    rt = RealtimeEvaluator(model, spec, RealtimeConfig.for_spec(spec, objectness_threshold=objectness_threshold),
                           device=device)
    return rt.evaluate_voc(voc_root, "test", output_dir=output_dir)


def record_rehearsal(work: str, result: Dict) -> str:
    """Keep `result` in WORK/rehearsal.json, a list of runs keyed by (model,
    crowded): a run again replaces its entry."""
    path = os.path.join(work, "rehearsal.json")
    runs = []
    if os.path.exists(path):
        with open(path) as f:
            runs = json.load(f)
    key = (result["model"], result["crowded"])
    runs = [r for r in runs if (r.get("model"), r.get("crowded")) != key] + [result]
    with open(path, "w") as f:
        json.dump(runs, f, indent=1)
    print(f"[rehearsal] recorded -> {path}")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda; cpu only when asked for)")
    ap.add_argument("work", nargs="?", default=None, help="work dir (default: dress_<model> in the temporary dir)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    s = settings()
    model_name, steps, batch = s["MODEL"], int(s["STEPS"]), int(s["BATCH"])
    n_train, n_test, crowded = int(s["TRAIN"]), int(s["TEST"]), bool(int(s["CROWDED"]))
    work = args.work or os.path.join(tempfile.gettempdir(), f"dress_{model_name}" + ("_crowded" if crowded else ""))
    os.makedirs(work, exist_ok=True)

    rec_dir = os.path.join(work, "records")
    if not os.path.exists(os.path.join(rec_dir, "synth_train_000.tfrecord")):
        make_dataset(work, n_train, n_test, crowded=crowded)
    voc_root = os.path.join(work, "VOCdevkit")

    if not os.environ.get("DR_SKIP_TRAIN"):
        ckpt = os.path.join(work, "vgg16_torch_init.pth")
        if not os.path.exists(ckpt):
            make_torch_vgg_checkpoint(ckpt)
        t0 = time.time()
        Trainer(train_config(model_name, work, steps, batch, crowded, ckpt), device=device).train()
        print(f"[train] {steps} steps in {(time.time() - t0) / 60:.1f} min")

    # the inference model: bf16, block 1 unfused, as the JAX tool's
    variables, step = CheckpointManager(os.path.join(work, "model")).restore_eval()
    model, spec = get_network(model_name, dtype=torch.bfloat16)
    model.load_state_dict({**variables["params"], **variables["batch_stats"]}, strict=True)
    print(f"[eval] restored step {step}")

    map07_s, map12_s, _, stats = streaming_eval(model, spec, rec_dir, crowded, device)
    print(f"[streaming] mAP07 {map07_s:.4f}  mAP12 {map12_s:.4f}  ({stats['sec_per_image'] * 1e3:.1f} ms/img)")

    t0 = time.time()
    map_rt, _ = realtime_eval(model, spec, voc_root, float(s["OBJ_THRESH"]), os.path.join(work, "rt_out"), device)
    rt_time = time.time() - t0
    print(f"[realtime] mAP07 {map_rt:.4f}  ({rt_time / n_test * 1e3:.1f} ms/img)")

    delta = abs(map07_s - map_rt)
    result = {
        "model": model_name, "crowded": crowded,
        "steps": step, "map07_streaming": round(map07_s, 4),
        "map12_streaming": round(map12_s, 4), "map07_realtime": round(map_rt, 4),
        "delta": round(delta, 4),
        "streaming_ms_per_img": round(stats["sec_per_image"] * 1e3, 2),
        "realtime_ms_per_img": round(rt_time / n_test * 1e3, 2),
    }
    with open(os.path.join(work, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    ok = map07_s >= PASS_MAP and delta <= MAX_DELTA
    result["ok"] = ok
    record_rehearsal(work, result)
    print("DRESS REHEARSAL:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
