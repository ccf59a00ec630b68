"""The port's synthetic dataset (`tools/synthetic_data.py`) against JAX's
`make_dataset` (`tools/synthetic_e2e.py`, loaded by path; it draws with
PIL's ImageDraw and encodes with Pillow).

- The same seed gives the same draws: labels and boxes, as the port's
  pipeline reads them from each side's records, are bit-equal, and so are
  the records of images with rectangles only (the port's encoder writes
  Pillow's bytes, and its rectangles are Pillow's pixels).
- Ellipses rasterize differently on their edge pixels, and JPEG spreads a
  changed pixel over its 8x8 block (16x16 for chroma): the decoded images
  agree within a mean absolute difference of 2.5 levels per image
  (measured at canvas 64: 0.99-1.70 on the images with an ellipse).
- The numpy shapes against ImageDraw directly: rectangles equal; an
  ellipse differs only on pixels that touch Pillow's ellipse edge.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageDraw

from ron_tensorflow_tpu_torch.data.jpeg import decode_rgb
from ron_tensorflow_tpu_torch.data.pipeline import PipelineConfig, batch_iterator, parse_voc_example
from ron_tensorflow_tpu_torch.data.tfrecord import read_records
from ron_tensorflow_tpu_torch.tools.synthetic_data import fill_ellipse, fill_rectangle, make_dataset

REPO = Path(__file__).resolve().parent.parent
MEAN_ABS_TOL = 2.5
N_TRAIN, N_TEST, CANVAS = 8, 4, 64


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_synthetic_e2e", REPO / "tools" / "synthetic_e2e.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    jax_tool().make_dataset(str(root / "jax"), n_train=N_TRAIN, n_test=N_TEST, seed=0, canvas=CANVAS)
    make_dataset(str(root / "port"), n_train=N_TRAIN, n_test=N_TEST, seed=0, canvas=CANVAS)
    return root


@pytest.mark.parametrize("split, n", [("train", N_TRAIN), ("test", N_TEST)])
def test_gts_through_the_pipeline_are_bit_equal(datasets, split, n):
    cfg = PipelineConfig(batch_size=n, working_shape=(CANVAS, CANVAS), max_boxes=8, shuffle=False,
                         keep_difficult=True)
    jax_b, port_b = (next(batch_iterator([str(datasets / side / f"synth_{split}_000.tfrecord")], cfg, epochs=1))
                     for side in ("jax", "port"))
    for key in ("gt_labels", "gt_boxes", "gt_valid", "gt_difficult"):
        np.testing.assert_array_equal(port_b[key], jax_b[key], err_msg=key)
    assert port_b["gt_valid"].sum() >= n


@pytest.mark.parametrize("split", ["train", "test"])
def test_images_agree(datasets, split):
    jax_records = list(read_records(str(datasets / "jax" / f"synth_{split}_000.tfrecord")))
    port_records = list(read_records(str(datasets / "port" / f"synth_{split}_000.tfrecord")))
    assert len(jax_records) == len(port_records)
    kinds = set()
    for jr, pr in zip(jax_records, port_records):
        j, p = parse_voc_example(jr), parse_voc_example(pr)
        np.testing.assert_array_equal(p["labels"], j["labels"])
        if (p["labels"] <= 3).all():  # rectangles only
            assert pr == jr
            kinds.add("rectangles")
        else:
            diff = np.abs(decode_rgb(p["jpeg"]).astype(np.int32) - decode_rgb(j["jpeg"]).astype(np.int32))
            assert diff.mean() <= MEAN_ABS_TOL, diff.mean()
            kinds.add("ellipse")
    assert kinds == {"rectangles", "ellipse"}


def boxes(seed, canvas, n=40):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        w, h = rng.uniform(0.25, 0.55, 2) * canvas
        x0, y0 = rng.uniform(0, canvas - w), rng.uniform(0, canvas - h)
        yield x0, y0, x0 + w, y0 + h


@pytest.mark.parametrize("canvas", [64, 400])
def test_shapes_against_imagedraw(canvas):
    color = (230, 40, 230)
    for box in boxes(canvas, canvas):
        im = Image.new("RGB", (canvas, canvas))
        ImageDraw.Draw(im).rectangle(box, fill=color)
        got = np.zeros((canvas, canvas, 3), np.uint8)
        fill_rectangle(got, box, color)
        np.testing.assert_array_equal(got, np.asarray(im))

        im = Image.new("L", (canvas, canvas))
        ImageDraw.Draw(im).ellipse(box, fill=255)
        ref = np.asarray(im) > 0
        got = np.zeros((canvas, canvas, 3), np.uint8)
        fill_ellipse(got, box, color)
        mask = (got == color).all(-1)
        padded = np.pad(ref, 1, mode="edge")
        neighbours = [padded[1 + dy: 1 + dy + canvas, 1 + dx: 1 + dx + canvas]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        edge = np.any([n != ref for n in neighbours], axis=0)  # pixels with an 8-neighbour across the edge
        assert mask.sum() > 0.9 * ref.sum()
        assert not (mask != ref)[~edge].any()
