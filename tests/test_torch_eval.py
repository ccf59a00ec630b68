"""The port's evaluation slice against the JAX package, on the CPU: the TP/FP
matcher, the AP and VOC evaluation copies, the eval resize strategies, JPEG
decode, and both evaluators (StreamingEvaluator, RealtimeEvaluator) on a
tiny RON with the same numpy-made weights on both sides.

Tolerances: TP/FP marks, gt counts, labels and keep sets equal; the eval
preprocessing bit for bit (as tests/test_reference_parity.py holds the JAX
package to the reference); mAP and per-class AP within 1e-6; realtime pixel
boxes within 1e-5 of the net's width (both sides decode in float32 and
differ by a few ulps).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.data import pipeline as jax_pipeline
from ron_tensorflow_tpu.data import resize as jax_resize
from ron_tensorflow_tpu.data.preprocess import whiten as jax_whiten
from ron_tensorflow_tpu.data.voc import parse_annotation as jax_parse_annotation
from ron_tensorflow_tpu.eval import PascalVocEvaluator as JaxPascalVocEvaluator
from ron_tensorflow_tpu.eval import RealtimeEvaluator as JaxRealtimeEvaluator
from ron_tensorflow_tpu.eval import StreamingEvaluator as JaxStreamingEvaluator
from ron_tensorflow_tpu.inference import np_methods as jax_np_methods
from ron_tensorflow_tpu.inference.detector import DetectionConfig as JaxDetectionConfig
from ron_tensorflow_tpu.inference.detector import Detector as JaxDetector
from ron_tensorflow_tpu.inference.detector import RealtimeConfig as JaxRealtimeConfig
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.ops import ap as jax_ap
from ron_tensorflow_tpu.ops import matching as jax_matching
from ron_tensorflow_tpu.utils import visualization as jax_visualization

from ron_tensorflow_tpu_torch.data import decode, resize
from ron_tensorflow_tpu_torch.data.voc import parse_annotation
from ron_tensorflow_tpu_torch.eval import PascalVocEvaluator, RealtimeEvaluator, StreamingEvaluator
from ron_tensorflow_tpu_torch.inference import np_methods
from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, RealtimeConfig
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC
from ron_tensorflow_tpu_torch.ops import ap, matching
from ron_tensorflow_tpu_torch.utils import visualization
from test_torch_realtime import make_tiny

REPO = Path(__file__).resolve().parent.parent
FIXTURES = "tests/fixtures/reference_parity.npz"
NUM_CLASSES = RON_TINY_SPEC.num_classes


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURES)


@pytest.fixture(scope="module")
def tiny():
    return make_tiny(seed=7)


def t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


# --------------------------------------------------------------------------- #
# matching


def assert_match_equal(got, ref):
    assert got.tp.dtype == torch.bool and got.fp.dtype == torch.bool and got.n_gt.dtype == torch.int32
    np.testing.assert_array_equal(got.n_gt.numpy(), np.asarray(ref.n_gt))
    np.testing.assert_array_equal(got.tp.numpy(), np.asarray(ref.tp))
    np.testing.assert_array_equal(got.fp.numpy(), np.asarray(ref.fp))


@pytest.mark.parametrize("case", ["m1", "m2"])
def test_match_detections_reference_parity(fx, case):
    """The reference's own TP/FP marks (tests/test_reference_parity.py),
    and JAX's, on its cases."""
    args = (int(fx[f"match_{case}_label"]), fx[f"match_{case}_det_scores"], fx[f"match_{case}_det_boxes"],
            fx[f"match_{case}_glabels"].astype(np.int32), fx[f"match_{case}_gboxes"],
            fx[f"match_{case}_gdifficults"])
    got = matching.match_detections(*t(*args), matching_threshold=0.5)
    assert int(got.n_gt) == int(fx[f"match_{case}_n_gt"])
    np.testing.assert_array_equal(got.tp.numpy(), fx[f"match_{case}_tp"])
    np.testing.assert_array_equal(got.fp.numpy(), fx[f"match_{case}_fp"])
    assert_match_equal(got, jax_matching.match_detections(*args, matching_threshold=0.5))


def random_match_case(seed, k=30, g=8):
    """Detections (some near-copies of gts, some duplicates, zero-score
    padding at the end) against gts with difficult flags and padding."""
    rng = np.random.default_rng(seed)
    gl = rng.integers(1, 4, g).astype(np.int32)
    gl[-2:] = 0  # padding
    cy, cx = rng.uniform(0.2, 0.8, (2, g))
    h, w = rng.uniform(0.1, 0.4, (2, g))
    gb = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1).astype(np.float32)
    gb[-2:] = 0.0
    gd = (rng.uniform(size=g) < 0.25).astype(np.int32)
    src = rng.integers(0, g, k)
    boxes = (gb[src] + rng.normal(0, 0.04, (k, 4))).astype(np.float32)
    boxes[rng.uniform(size=k) < 0.2] = rng.uniform(0, 1, 4).astype(np.float32)
    scores = np.sort(rng.uniform(0.01, 1.0, k))[::-1].astype(np.float32)
    scores[-5:] = 0.0
    boxes[-5:] = 0.0
    return scores, boxes, gl, gb, gd


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("label", [1, 2, 3])
def test_match_detections_matches_jax(seed, label):
    scores, boxes, gl, gb, gd = random_match_case(seed)
    ref = jax_matching.match_detections(label, scores, boxes, gl, gb, gd, 0.5)
    got = matching.match_detections(*t(label, scores, boxes, gl, gb, gd), 0.5)
    assert_match_equal(got, ref)


@pytest.mark.parametrize("gt0_difficult", [0, 1])
def test_all_zero_iou_row_follows_gt0(gt0_difficult):
    """No same-class gt overlaps the detection: the argmax is gt 0 (of
    another class here), so fp follows gt 0's difficult flag, in JAX too."""
    gl = np.array([2, 1, 0], np.int32)
    gb = np.array([[0.0, 0.0, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9], [0, 0, 0, 0]], np.float32)
    gd = np.array([gt0_difficult, 0, 0], np.int32)
    scores = np.array([0.9, 0.5, 0.0], np.float32)
    boxes = np.array([[0.0, 0.0, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9], [0, 0, 0, 0]], np.float32)
    ref = jax_matching.match_detections(1, scores, boxes, gl, gb, gd, 0.5)
    got = matching.match_detections(*t(1, scores, boxes, gl, gb, gd), 0.5)
    assert_match_equal(got, ref)
    # detection 0 overlaps no class-1 gt; the zero-score padding (2) neither
    assert got.fp.tolist() == [not gt0_difficult, False, not gt0_difficult]
    assert got.tp.tolist() == [False, True, False]


def test_match_threshold_is_strict():
    """IoU exactly 0.5 is no match (IoU > threshold)."""
    gl, gd = np.array([1], np.int32), np.array([0], np.int32)
    gb = np.array([[0.0, 0.0, 1.0, 0.5]], np.float32)
    boxes = np.array([[0.0, 0.0, 1.0, 1.0]], np.float32)
    scores = np.array([0.9], np.float32)
    got = matching.match_detections(*t(1, scores, boxes, gl, gb, gd), 0.5)
    assert_match_equal(got, jax_matching.match_detections(1, scores, boxes, gl, gb, gd, 0.5))
    assert got.fp.tolist() == [True]


def test_match_all_classes_batched_matches_jax():
    """[B, C-1, K] stacks against [B, G] gts, as the streaming evaluator
    calls it, against JAX's vmap of match_all_classes over the batch."""
    cases = [random_match_case(s, k=24, g=6) for s in range(3)]
    c = 4
    scores = np.stack([np.stack([cs[0]] * (c - 1)) for cs in cases])
    boxes = np.stack([np.stack([np.roll(cs[1], i, 0) for i in range(c - 1)]) for cs in cases])
    gl, gb, gd = (np.stack([cs[j] for cs in cases]) for j in (2, 3, 4))
    ref = jax.vmap(lambda s, b, l, g, d: jax_matching.match_all_classes(c, s, b, l, g, d, 0.5))(
        *(jnp.asarray(a) for a in (scores, boxes, gl, gb, gd)))
    got = matching.match_all_classes(c, *t(scores, boxes, gl, gb, gd), 0.5)
    assert got.tp.shape == (3, c - 1, 24)
    assert_match_equal(got, ref)
    one = matching.match_detections_batch(2, *t(scores[:, 1], boxes[:, 1], gl, gb, gd), 0.5)
    assert torch.equal(one.tp, got.tp[:, 1]) and torch.equal(one.fp, got.fp[:, 1])


# --------------------------------------------------------------------------- #
# AP and the offline VOC evaluator (copies)


@pytest.mark.parametrize("case", ["m1", "m2"])
def test_precision_recall_and_ap_reference_parity(fx, case):
    prec, rec = ap.precision_recall(int(fx[f"match_{case}_n_gt"]), fx[f"match_{case}_tp"],
                                    fx[f"match_{case}_fp"], fx[f"match_{case}_det_scores"])
    np.testing.assert_allclose(prec, fx[f"ap_{case}_precision"], atol=1e-12, rtol=0)
    np.testing.assert_allclose(rec, fx[f"ap_{case}_recall"], atol=1e-12, rtol=0)
    assert abs(ap.average_precision_voc07(prec, rec) - fx[f"ap_{case}_voc07"]) < 1e-12
    assert abs(ap.average_precision_voc12(prec, rec) - fx[f"ap_{case}_voc12"]) < 1e-12


def test_streaming_tp_fp_matches_jax():
    rng = np.random.default_rng(0)
    got, ref = ap.StreamingTpFp(5), jax_ap.StreamingTpFp(5)
    for _ in range(6):
        for c in range(5):
            n_gt = int(rng.integers(0, 4))
            scores = np.where(rng.uniform(size=10) < 0.2, 0.0, rng.uniform(size=10))
            tp = rng.uniform(size=10) < 0.4
            fp = ~tp & (rng.uniform(size=10) < 0.7)
            got.add(c, n_gt, scores, tp, fp)
            ref.add(c, n_gt, scores, tp, fp)
    for protocol in ("voc07", "voc12"):
        assert got.mean_average_precision(protocol) == ref.mean_average_precision(protocol)
    with pytest.raises(ValueError):
        got.average_precision(1, "voc10")


def write_devkit(root, images, with_jpegs=True):
    """A VOC2007 tree under root: images {id: (height, width, [(name,
    (x1, y1, x2, y2), difficult), ...])}; JPEGs of seeded noise."""
    year = Path(root) / "VOC2007"
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        (year / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(len(images))
    for image_id, (h, w, objs) in images.items():
        parts = [f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth></size>"]
        for name, (x1, y1, x2, y2), diff in objs:
            parts.append(f"<object><name>{name}</name><difficult>{diff}</difficult><truncated>0</truncated>"
                         f"<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>"
                         f"</bndbox></object>")
        parts.append("</annotation>")
        (year / "Annotations" / f"{image_id}.xml").write_text("".join(parts))
        if with_jpegs:
            from PIL import Image

            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(year / "JPEGImages" / f"{image_id}.jpg")
    (year / "ImageSets" / "Main" / "test.txt").write_text("".join(f"{i}\n" for i in images))
    return str(root)


DEVKIT = {
    "000001": (320, 320, [("dog", (50, 50, 150, 150), 0), ("car", (200, 200, 300, 280), 0)]),
    "000002": (240, 300, [("dog", (20, 30, 120, 160), 0), ("dog", (150, 100, 250, 200), 1)]),
    "000003": (200, 180, [("person", (10.5, 20, 90, 150.25), 0)]),
}


def test_parse_annotation_matches_jax(tmp_path):
    root = write_devkit(tmp_path / "VOCdevkit", DEVKIT, with_jpegs=False)
    for image_id in DEVKIT:
        path = os.path.join(root, "VOC2007", "Annotations", f"{image_id}.xml")
        assert dataclasses.asdict(parse_annotation(path)) == dataclasses.asdict(jax_parse_annotation(path))


def test_pascal_voc_evaluator_matches_jax(tmp_path):
    root = write_devkit(tmp_path / "VOCdevkit", DEVKIT, with_jpegs=False)
    rng = np.random.default_rng(3)
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in DEVKIT] for _ in range(NUM_CLASSES)]
    for cls in (7, 12, 15):
        for ii in range(len(DEVKIT)):
            n = int(rng.integers(0, 4))
            x1, y1 = rng.uniform(0, 150, (2, n))
            all_boxes[cls][ii] = np.stack([x1, y1, x1 + rng.uniform(20, 120, n), y1 + rng.uniform(20, 120, n),
                                           rng.uniform(size=n)], -1).astype(np.float32)
    all_boxes[12][0] = np.concatenate([all_boxes[12][0], [[49, 49, 149, 149, 0.95]]]).astype(np.float32)
    for use_07 in (True, False):
        got = PascalVocEvaluator(root, "test").evaluate(all_boxes, use_07_metric=use_07)
        ref = JaxPascalVocEvaluator(root, "test").evaluate(all_boxes, use_07_metric=use_07)
        assert got == ref
    assert got[1]["dog"] > 0
    PascalVocEvaluator(root, "test").write_results_files(all_boxes, str(tmp_path / "port"))
    JaxPascalVocEvaluator(root, "test").write_results_files(all_boxes, str(tmp_path / "jax"))
    for f in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()


# --------------------------------------------------------------------------- #
# eval resize strategies and JPEG decode


STRATEGIES = ["NONE", "CENTRAL_CROP", "PAD_AND_RESIZE", "WARP_RESIZE"]


@pytest.mark.parametrize("tag", ["big", "small"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_preprocess_for_eval_reference_parity(fx, tag, strategy):
    """Bit for bit the reference's own preprocess_for_eval outputs, as
    tests/test_reference_parity.py holds the JAX package to them."""
    img, boxes, bbox_img = resize.preprocess_for_eval(fx[f"pre_{tag}_image"], fx[f"pre_{tag}_gt_boxes"],
                                                      strategy, (320, 320))
    key = f"pre_{tag}_{strategy.lower()}"
    np.testing.assert_array_equal(img, fx[key + "_image"])
    np.testing.assert_array_equal(boxes, fx[key + "_boxes"])
    np.testing.assert_array_equal(bbox_img, fx[key + "_bbox_img"])


@pytest.mark.parametrize("tag", ["big", "small"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_remap_boxes_for_eval_matches_preprocess_and_jax(fx, tag, strategy):
    image, gt = fx[f"pre_{tag}_image"], fx[f"pre_{tag}_gt_boxes"]
    got = resize.remap_boxes_for_eval(gt, image.shape[:2], strategy, (320, 320))
    np.testing.assert_array_equal(got, fx[f"pre_{tag}_{strategy.lower()}_boxes"])
    np.testing.assert_array_equal(got, jax_resize.remap_boxes_for_eval(gt, image.shape[:2], strategy, (320, 320)))


def test_central_crop_or_pad_matches_jax():
    rng = np.random.default_rng(0)
    image = rng.uniform(-120, 120, (37, 90, 3)).astype(np.float32)
    boxes = rng.uniform(0, 1, (5, 4)).astype(np.float32)
    for target in ((64, 64), (20, 120), (37, 90)):
        got = resize.central_crop_or_pad(image, boxes, target)
        ref = jax_resize.central_crop_or_pad(image, boxes, target)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_unknown_resize_strategy_raises():
    with pytest.raises(ValueError):
        resize.preprocess_for_eval(np.zeros((4, 4, 3), np.uint8), np.zeros((0, 4)), "STRETCH")
    with pytest.raises(ValueError):
        resize.remap_boxes_for_eval(np.zeros((1, 4)), (4, 4), "STRETCH")


@pytest.fixture(scope="module")
def jpeg_bytes():
    import io

    from PIL import Image

    rng = np.random.default_rng(1)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (45, 70, 3), np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def test_decode_jpeg_matches_jax(jpeg_bytes):
    np.testing.assert_array_equal(decode.decode_jpeg_raw(jpeg_bytes), jax_pipeline.decode_jpeg_raw(jpeg_bytes))
    np.testing.assert_array_equal(decode.decode_jpeg(jpeg_bytes, (32, 48)),
                                  jax_pipeline.decode_jpeg(jpeg_bytes, (32, 48)))


@pytest.mark.parametrize("strategy", STRATEGIES[1:])
def test_decode_jpeg_eval_matches_jax(jpeg_bytes, strategy):
    np.testing.assert_array_equal(decode.decode_jpeg_eval(jpeg_bytes, (64, 64), strategy),
                                  jax_pipeline.decode_jpeg_eval(jpeg_bytes, (64, 64), strategy))


def test_decode_falls_back_to_pil(jpeg_bytes, monkeypatch):
    """Without cv2 the port decodes as Pillow does: its own decoder needs
    neither library."""
    import io

    from PIL import Image

    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    ref = np.asarray(Image.open(io.BytesIO(jpeg_bytes)).convert("RGB"))
    np.testing.assert_array_equal(decode.decode_jpeg_raw(jpeg_bytes), ref)
    assert decode.decode_jpeg(jpeg_bytes, (32, 48)).shape == (32, 48, 3)


def test_decode_without_cv2_or_pil_uses_the_native_backend(jpeg_bytes, monkeypatch):
    """A host with neither library decodes through the port's own decoder,
    bit-equal to cv2 (JAX's decode, which runs cv2 here)."""
    want_raw = jax_pipeline.decode_jpeg_raw(jpeg_bytes)
    want_train = jax_pipeline.decode_jpeg(jpeg_bytes, (32, 48))
    want_eval = jax_pipeline.decode_jpeg_eval(jpeg_bytes, (64, 64), "WARP_RESIZE")
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(decode.decode_jpeg_raw(jpeg_bytes), want_raw)
    np.testing.assert_array_equal(decode.decode_jpeg(jpeg_bytes, (32, 48)), want_train)
    np.testing.assert_array_equal(decode.decode_jpeg_eval(jpeg_bytes, (64, 64), "WARP_RESIZE"), want_eval)


def test_port_imports_without_cv2_and_pil():
    """No module of the port needs cv2 or PIL to be imported: a GPU host may
    have neither."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "for name in ('cv2', 'PIL'):",
        "    sys.modules[name] = None",
        "import ron_tensorflow_tpu_torch as p",
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):",
        "    importlib.import_module(m.name)",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


# --------------------------------------------------------------------------- #
# numpy demo path and debug drawing (copies)


def test_np_methods_detect_matches_jax():
    rng = np.random.default_rng(2)
    n = JAX_TINY_SPEC.anchor_layout().num_anchors
    logits = rng.normal(0, 3, (n, NUM_CLASSES))
    preds = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    locations = rng.normal(0, 0.5, (n, 4))
    anchors = RON_TINY_SPEC.anchor_layout().cyxhw
    got = np_methods.detect(preds, locations, anchors, select_threshold=0.5, nms_threshold=0.45)
    ref = jax_np_methods.detect(preds, locations, anchors, select_threshold=0.5, nms_threshold=0.45)
    assert len(got[0]) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_save_image_with_boxes_matches_jax(tmp_path):
    """The port draws in numpy: JAX's picture outside both captions (the
    port's bitmap font and PIL's text), and the JPEG Pillow writes for the
    port's picture, byte for byte."""
    import io

    from PIL import Image, ImageDraw

    rng = np.random.default_rng(3)
    image01 = rng.uniform(size=(40, 60, 3)).astype(np.float32)
    boxes = np.array([[0.1, 0.1, 0.5, 0.6], [0.2, 0.3, 0.9, 0.8]], np.float32)
    args = (image01, boxes, np.array([12, 0]), np.array([0.9, 0.4]))
    got = visualization.save_image_with_boxes(*args, directory=str(tmp_path / "port"), index=3)
    ref = jax_visualization.save_image_with_boxes(*args, directory=str(tmp_path / "jax"), index=3)
    assert Path(got).name == Path(ref).name == "3.jpg"
    picture = visualization.draw_boxes(*args)
    buf = io.BytesIO()
    Image.fromarray(picture).save(buf, format="JPEG")
    assert Path(got).read_bytes() == buf.getvalue()
    jax_picture = np.asarray(jax_visualization.draw_boxes(*args))
    text = visualization.caption(12, 0.9, ("bg",) + visualization.VOC_CLASSES)  # "dog 0.90"
    x, y = 0.1 * 60 + 2, 0.1 * 40 + 2
    outside = np.ones((40, 60), bool)
    x0, y0, x1, y1 = visualization.caption_box(x, y, text)
    outside[y0:y1, x0:x1] = False
    x0, y0, x1, y1 = ImageDraw.Draw(Image.new("RGB", (60, 40))).textbbox((x, y), text)
    outside[int(y0):int(np.ceil(y1)) + 1, int(x0):int(np.ceil(x1)) + 1] = False
    assert outside.sum() > 1000
    np.testing.assert_array_equal(picture[outside], jax_picture[outside])


# --------------------------------------------------------------------------- #
# the evaluators


def gt_from_detections(scores, boxes, rng, g=6):
    """Per-image GT made from the JAX Detector's own detections, so the
    matcher sees TPs, duplicates, misses, difficult gts and padding: the top
    3 detections of each image jittered, the 4th as a difficult gt, one
    random box of a random class, padding last."""
    b = scores.shape[0]
    labels = np.zeros((b, g), np.int32)
    gboxes = np.zeros((b, g, 4), np.float32)
    difficult = np.zeros((b, g), np.int32)
    for i in range(b):
        flat = np.argsort(-scores[i].reshape(-1), kind="stable")[:4]
        cls, k = np.unravel_index(flat, scores[i].shape)
        labels[i, :4] = cls + 1
        gboxes[i, :4] = boxes[i, cls, k] + rng.normal(0, 0.01, (4, 4))
        difficult[i, 3] = 1
        labels[i, 4] = rng.integers(1, NUM_CLASSES)
        gboxes[i, 4] = np.sort(rng.uniform(0, 1, 4)).reshape(2, 2).T.reshape(-1)
    return labels, gboxes, difficult


def streaming_batches(jmodel, jvars, n_batches, b, uint8, short_last):
    """Batches of seeded pixels (uint8, or whitened float32) with gts made
    from the JAX Detector's detections on them."""
    rng = np.random.default_rng(21)
    jdet = JaxDetector(jmodel, JAX_TINY_SPEC, JaxDetectionConfig(top_k=64, keep_top_k=16, objectness_threshold=0.0))
    out = []
    for bi in range(n_batches):
        pixels = rng.integers(0, 256, (b, 64, 64, 3)).astype(np.uint8)
        image = np.array(jax_whiten(jnp.asarray(pixels, jnp.float32) / 255.0))
        with jax.default_matmul_precision("highest"):
            s, bx = (np.asarray(a) for a in jdet(jvars, jnp.asarray(image)))
        gl, gb, gd = gt_from_detections(s, bx, rng)
        batch = {"image": pixels if uint8 else image, "gt_labels": gl, "gt_boxes": gb, "gt_difficult": gd}
        if short_last and bi == n_batches - 1:
            batch["sample_valid"] = np.arange(b) < b - 1
        out.append(batch)
    return out


@pytest.mark.parametrize("uint8,short_last", [(False, False), (True, True)])
def test_streaming_evaluator_matches_jax(tiny, uint8, short_last):
    """StreamingEvaluator.run against JAX's on the same batches: whitened
    float images, or uint8 pixels whitened on the device with a padded
    last batch."""
    jmodel, jvars, model = tiny
    batches = streaming_batches(jmodel, jvars, 3, 2, uint8, short_last)
    jcfg = JaxDetectionConfig(top_k=64, keep_top_k=16, objectness_threshold=0.0)
    with jax.default_matmul_precision("highest"):
        ref = JaxStreamingEvaluator(jmodel, JAX_TINY_SPEC, jcfg).run(jvars, iter(batches), log_every=0)
    ev = StreamingEvaluator(model, RON_TINY_SPEC, DetectionConfig(top_k=64, keep_top_k=16, objectness_threshold=0.0),
                            device="cpu")
    got = ev.run(iter(batches), log_every=0)
    assert got[3]["images"] == ref[3]["images"] == 6 - int(short_last)
    assert got[0] == pytest.approx(ref[0], abs=1e-6) and got[1] == pytest.approx(ref[1], abs=1e-6)
    assert got[2] == pytest.approx(ref[2], abs=1e-6)
    assert got[0] > 0.05  # the detections met their own gts
    assert sum(ev.accumulator.class_arrays(c)[1].sum() for c in range(1, NUM_CLASSES)) > 0


def test_streaming_evaluator_max_batches_and_debug_dir(tiny, tmp_path):
    jmodel, jvars, model = tiny
    batches = streaming_batches(jmodel, jvars, 3, 2, False, False)
    ev = StreamingEvaluator(model, RON_TINY_SPEC, DetectionConfig(top_k=64, keep_top_k=16, objectness_threshold=0.0),
                            device="cpu")
    _, _, _, stats = ev.run(iter(batches), max_batches=2, log_every=1, debug_dir=str(tmp_path),
                            debug_max_images=3, debug_score_threshold=0.0)
    assert stats["images"] == 4
    assert sorted(os.listdir(tmp_path)) == ["0.jpg", "1.jpg", "2.jpg"]


RT_CONFIG = dict(objectness_threshold=0.0, select_threshold=0.01, top_k=64, keep_top_k=16)


def assert_per_class_close(got, ref, width):
    assert set(got) == set(ref)
    for cls in ref:
        np.testing.assert_allclose(got[cls], ref[cls], rtol=0, atol=1e-5 * width)


def test_realtime_detect_batch_matches_jax(tiny):
    """The batch of tests/test_eval.py:243-273 (three frames of mixed
    original sizes, per-image min sizes) through both evaluators; and the
    port's batch against its own per-image path."""
    jmodel, jvars, model = tiny
    rng = np.random.default_rng(3)
    images = rng.normal(0.5, 0.2, (3, 64, 64, 3)).astype(np.float32)
    orig_shapes = [(480, 640), (333, 500), (64, 64)]
    with jax.default_matmul_precision("highest"):
        ref = JaxRealtimeEvaluator(jmodel, JAX_TINY_SPEC, JaxRealtimeConfig(**RT_CONFIG)).detect_batch(
            jvars, images, orig_shapes)
    ev = RealtimeEvaluator(model, RON_TINY_SPEC, RealtimeConfig(**RT_CONFIG), device="cpu")
    got = ev.detect_batch(images, orig_shapes)
    assert len(got) == 3 and sum(len(d) for d in got) > 0
    for g, r in zip(got, ref):
        assert_per_class_close(g, r, 64)
    for i in range(3):
        single = ev.detect_image(images[i], orig_shape=orig_shapes[i])
        assert_per_class_close(single, got[i], 64)


def test_realtime_evaluate_voc_matches_jax(tiny, tmp_path):
    """evaluate_voc against JAX's on a VOCdevkit of seeded JPEGs of mixed
    sizes, 5 images in batches of 2 (the last one padded), with gts made
    from JAX's own detections, so that the APs are not all 0."""
    jmodel, jvars, model = tiny
    shapes = {"000001": (48, 64), "000002": (80, 60), "000003": (64, 64), "000004": (50, 90), "000005": (72, 40)}
    first = write_devkit(tmp_path / "probe", {i: (h, w, []) for i, (h, w) in shapes.items()})
    jev = JaxRealtimeEvaluator(jmodel, JAX_TINY_SPEC, JaxRealtimeConfig(**RT_CONFIG))
    with jax.default_matmul_precision("highest"):
        jev.evaluate_voc(jvars, first, output_dir=str(tmp_path / "probe_out"), batch_size=2, decode_workers=2)
    with open(tmp_path / "probe_out" / "detections.pkl", "rb") as f:
        probe = pickle.load(f)
    from ron_tensorflow_tpu.data.voc import VOC_CLASSES

    devkit = {}
    for ii, (image_id, (h, w)) in enumerate(shapes.items()):
        objs = []
        for cls in range(1, NUM_CLASSES):
            for x1, y1, x2, y2, _ in probe[cls][ii][:2]:
                objs.append((VOC_CLASSES[cls - 1], (x1 + 1, y1 + 1, x2 + 1, y2 + 1), int(len(objs) == 2)))
        devkit[image_id] = (h, w, objs)
    root = write_devkit(tmp_path / "VOCdevkit", devkit)
    with jax.default_matmul_precision("highest"):
        ref = jev.evaluate_voc(jvars, root, output_dir=str(tmp_path / "jax"), batch_size=2, decode_workers=2)
    ev = RealtimeEvaluator(model, RON_TINY_SPEC, RealtimeConfig(**RT_CONFIG), device="cpu")
    got = ev.evaluate_voc(root, output_dir=str(tmp_path / "port"), batch_size=2, decode_workers=2)
    assert got[0] == pytest.approx(ref[0], abs=1e-6)
    assert got[1] == pytest.approx(ref[1], abs=1e-6)
    assert got[0] > 0.1
    with open(tmp_path / "jax" / "detections.pkl", "rb") as f:
        ref_boxes = pickle.load(f)
    with open(tmp_path / "port" / "detections.pkl", "rb") as f:
        got_boxes = pickle.load(f)
    for cls in range(NUM_CLASSES):
        for g, r in zip(got_boxes[cls], ref_boxes[cls]):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * 90)
    assert got == ev.evaluate_voc(root, max_images=5, batch_size=3)


@pytest.mark.parametrize("evaluator", [StreamingEvaluator, RealtimeEvaluator])
def test_evaluators_default_to_cuda(tiny, evaluator):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        evaluator(tiny[2], RON_TINY_SPEC)
