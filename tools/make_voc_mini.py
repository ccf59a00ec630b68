"""Make the small VOCdevkit fixture and its JAX references.

    JAX_PLATFORMS=cpu python tools/make_voc_mini.py

Writes, where JAX, Pillow and OpenCV are installed:

- `tests/fixtures/voc_mini/VOC2007/` (`Annotations/`, `JPEGImages/`,
  `ImageSets/Main/test.txt`): eight JPEGs that Pillow encodes (quality 90)
  from the four demo images of `tests/fixtures/e2e_parity_trained.npz`:
  000001-000004 at 320x320, 000005-000006 resized to VOC's 500x375 and
  000007-000008 to 375x500. 000002 is grayscale, 000003 4:4:4, 000004 has
  restart markers, the rest 4:2:0. Each XML holds the image's published
  realtime reference detections (the gts `chip_smoke.py` scores with), in
  pixels of its frame; the last object of 000003 is marked difficult.
- `tests/fixtures/voc_mini_ref.npz`:
  - `raw_digest`, `eval_digest` [8]: blake2b (16 bytes, hex) of Pillow's
    RGB decode of each JPEG and of JAX's `decode_jpeg_eval(WARP_RESIZE)`
    canvas at 320x320; `shapes` [8, 2];
  - `cv2_resize_ids`, `cv2_resize` [2, 512, 512, 3]: cv2.resize(INTER_LINEAR)
    of the decodes of 000005 and 000007;
  - `batch/*`: JAX's first `batch_iterator` batch over the records that
    `chip_smoke.repeated_vocdevkit` + `convert_voc` make (264 samples in
    two shards; seed 0, batch 4, the trainer's pipeline: 512x512 uint8
    canvases, shuffled, difficult dropped);
  - `rt/*`: JAX's f32 `RealtimeEvaluator.evaluate_voc` over the eight images
    with the trained RON-320 weights and the published realtime config:
    `rows` [N, 5] (x1, y1, x2, y2, score in the original frame's pixels),
    `cls` [N], `image` [N] in (class, image) order, `map`, `aps` [20].

The records tree and its constants are `chip_smoke.py`'s, which builds the
same tree on the card; `python tools/make_voc_mini.py --batch-only`
rewrites only `batch/*` after a change there.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # chip_smoke.py, which defines the records tree
FIXTURES = REPO / "tests" / "fixtures"
TRAINED = FIXTURES / "e2e_parity_trained.npz"
VOC_MINI = FIXTURES / "voc_mini"
REF = FIXTURES / "voc_mini_ref.npz"
IDS = tuple(f"{i:06d}" for i in range(1, 9))
# id -> (demo image, (width, height) or None for 320x320, Pillow save options, grayscale)
LAYOUT = {
    "000001": ("1", None, {}, False),
    "000002": ("2", None, {}, True),
    "000003": ("3", None, {"subsampling": 0}, False),
    "000004": ("4", None, {"restart_marker_rows": 1}, False),
    "000005": ("1", (500, 375), {}, False),
    "000006": ("2", (500, 375), {}, False),
    "000007": ("3", (375, 500), {}, False),
    "000008": ("4", (375, 500), {}, False),
}
DIFFICULT = ("000003", -1)  # (id, object index) marked difficult
CV2_RESIZE_IDS = ("000005", "000007")
BATCH_CANVAS = (512, 512)
VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def digest(a: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(a).tobytes(), digest_size=16).hexdigest()


def annotation_xml(size_wh, objects) -> str:
    """VOC XML; objects [(name, (x1, y1, x2, y2) 1-based pixels, difficult)]."""
    w, h = size_wh
    parts = [f"<annotation><folder>VOC2007</folder><size><width>{w}</width><height>{h}</height>"
             "<depth>3</depth></size>"]
    for name, (x1, y1, x2, y2), diff in objects:
        parts.append(f"<object><name>{name}</name><pose>Unspecified</pose><truncated>0</truncated>"
                     f"<difficult>{diff}</difficult><bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>"
                     f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>")
    parts.append("</annotation>\n")
    return "".join(parts)


def write_voc_mini(root: Path = VOC_MINI) -> None:
    from PIL import Image

    fx = np.load(TRAINED, allow_pickle=False)
    year = root / "VOC2007"
    shutil.rmtree(root, ignore_errors=True)
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (year / sub).mkdir(parents=True)
    for image_id, (src, size, options, gray) in LAYOUT.items():
        img = Image.fromarray(fx[f"img_{src}_pixels"])
        if size is not None:
            img = img.resize(size, Image.BILINEAR)
        if gray:
            img = img.convert("L")
        img.save(year / "JPEGImages" / f"{image_id}.jpg", format="JPEG", quality=90, **options)
        w, h = img.size
        labels, boxes = fx[f"img_{src}_rt_published_labels"], fx[f"img_{src}_rt_published_boxes"]
        objects = []
        for k, (lab, (y1, x1, y2, x2)) in enumerate(zip(labels, boxes)):
            px = [int(np.clip(round(float(v) * s), 1, s)) for v, s in ((x1, w), (y1, h), (x2, w), (y2, h))]
            diff = int((image_id, k - len(labels)) == DIFFICULT)
            objects.append((VOC_CLASSES[int(lab) - 1], tuple(px), diff))
        (year / "Annotations" / f"{image_id}.xml").write_text(annotation_xml((w, h), objects))
    (year / "ImageSets" / "Main" / "test.txt").write_text("".join(f"{i}\n" for i in IDS))


def batch_reference() -> dict:
    """`batch/*`: JAX's first batch of the trainer's pipeline
    (`Trainer.make_batches`) over chip_smoke.py's records tree."""
    from chip_smoke import BATCH_SEED, BATCH_SIZE, RECORD_PATTERN, repeated_vocdevkit
    from ron_tensorflow_tpu.data import convert, pipeline
    from ron_tensorflow_tpu.data.tfrecord import list_shards

    config = pipeline.PipelineConfig(batch_size=BATCH_SIZE, working_shape=BATCH_CANVAS, max_boxes=56, shuffle=True,
                                     keep_difficult=False, seed=BATCH_SEED, cache_decoded=True, output_dtype="uint8")
    with tempfile.TemporaryDirectory() as tmp:
        records = Path(tmp) / "records"
        for year_dir, name in repeated_vocdevkit(VOC_MINI / "VOC2007", Path(tmp) / "voc"):
            convert.convert_voc(str(year_dir), str(records), name)
        files = list_shards(str(records), RECORD_PATTERN)
        batch = next(pipeline.batch_iterator(files, config, epochs=1))
    ref = {f"batch/{k}": v for k, v in batch.items()}
    ref["batch/shards"] = np.asarray([os.path.basename(f) for f in files])
    return ref


def make_reference() -> dict:
    import cv2
    import jax.numpy as jnp
    from PIL import Image

    from ron_tensorflow_tpu.data import pipeline
    from ron_tensorflow_tpu.eval import RealtimeEvaluator
    from ron_tensorflow_tpu.inference.detector import RealtimeConfig
    from ron_tensorflow_tpu.models.ron import RON, RON_320_SPEC
    from ron_tensorflow_tpu.train.checkpoint import unflatten_params

    year = VOC_MINI / "VOC2007"
    ref = {"ids": np.asarray(IDS)}
    raw_d, eval_d, shapes = [], [], []
    for image_id in IDS:
        data = (year / "JPEGImages" / f"{image_id}.jpg").read_bytes()
        raw = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        raw_d.append(digest(raw))
        eval_d.append(digest(pipeline.decode_jpeg_eval(data, (320, 320), "WARP_RESIZE")))
        shapes.append(raw.shape[:2])
    ref.update(raw_digest=np.asarray(raw_d), eval_digest=np.asarray(eval_d), shapes=np.asarray(shapes, np.int32))
    ref["cv2_resize_ids"] = np.asarray(CV2_RESIZE_IDS)
    ref["cv2_resize"] = np.stack([
        cv2.resize(np.asarray(Image.open(year / "JPEGImages" / f"{i}.jpg").convert("RGB")), BATCH_CANVAS[::-1],
                   interpolation=cv2.INTER_LINEAR) for i in CV2_RESIZE_IDS])

    ref.update(batch_reference())
    with tempfile.TemporaryDirectory() as tmp:
        fx = np.load(TRAINED, allow_pickle=False)
        unpack = lambda a: a.astype(np.uint32).__lshift__(16).view(np.float32)  # noqa: E731  bf16 bits -> f32
        variables = {"params": unflatten_params({k[4:]: jnp.asarray(unpack(fx[k])) for k in fx.files
                                                 if k.startswith("wp::")}),
                     "batch_stats": unflatten_params({k[4:]: jnp.asarray(unpack(fx[k])) for k in fx.files
                                                      if k.startswith("ws::")})}
        rt = RealtimeEvaluator(RON(spec=RON_320_SPEC), RON_320_SPEC,
                               RealtimeConfig.for_spec(RON_320_SPEC, objectness_threshold=0.95))
        out_dir = Path(tmp) / "rt"
        mean_ap, aps = rt.evaluate_voc(variables, str(VOC_MINI), "test", output_dir=str(out_dir))
        import pickle

        with open(out_dir / "detections.pkl", "rb") as f:
            all_boxes = pickle.load(f)
    rows, cls, image = [], [], []
    for c, per_image in enumerate(all_boxes):
        for ii, r in enumerate(per_image):
            for row in np.asarray(r, np.float32).reshape(-1, 5):
                rows.append(row)
                cls.append(c)
                image.append(ii)
    ref.update({"rt/rows": np.asarray(rows, np.float32).reshape(-1, 5), "rt/cls": np.asarray(cls, np.int32),
                "rt/image": np.asarray(image, np.int32), "rt/map": np.float64(mean_ap),
                "rt/aps": np.asarray([aps[c] for c in VOC_CLASSES], np.float64)})
    return ref


def main() -> int:
    batch_only = sys.argv[1:] == ["--batch-only"]
    if batch_only:
        ref = {**{k: v for k, v in np.load(REF, allow_pickle=False).items() if not k.startswith("batch/")},
               **batch_reference()}
    else:
        write_voc_mini()
        ref = make_reference()
    np.savez_compressed(REF, **ref)
    size = sum(p.stat().st_size for p in VOC_MINI.rglob("*") if p.is_file()) + REF.stat().st_size
    print(f"wrote {'batch/* of ' if batch_only else f'{VOC_MINI} and '}{REF}: {size / 1e6:.2f} MB; realtime rows "
          f"{len(ref['rt/rows'])}, mAP {float(ref['rt/map']):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
