"""Pictures drawn and written without PIL (`utils/visualization.py`) against
Pillow 12's own drawing and JPEG writer.

- `draw_rectangle` fills exactly the pixels of Pillow's
  `ImageDraw.rectangle(xy, outline=..., width=2)` for seeded float corners,
  inside, across and outside the image's edges, and for rectangles lower
  or narrower than the outline (where Pillow paints a row or two outside
  the corners).
- `draw_boxes` equals Pillow's rectangles, drawn in the same order and
  colours, everywhere outside the caption boxes; each caption is drawn in
  its class colour inside its box, from the bitmap font, which has a glyph
  for every character of the VOC class names and the scores.
- `save_image_with_boxes` writes the bytes of Pillow's `save` of the same
  array (quality 75, 4:2:0), and runs with PIL and cv2 unimportable.
"""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageDraw

from ron_tensorflow_tpu_torch.data.voc import VOC_CLASSES
from ron_tensorflow_tpu_torch.utils import visualization as vis

REPO = Path(__file__).resolve().parent.parent
NAMES = ("bg",) + VOC_CLASSES


def pil_rectangle(shape, xy, width=2):
    img = Image.new("RGB", shape[1::-1])
    ImageDraw.Draw(img).rectangle(xy, outline=(255, 255, 255), width=width)
    return np.asarray(img)


@pytest.mark.parametrize("seed", range(4))
def test_rectangle_fills_pillows_pixels(seed):
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(20, 60)), int(rng.integers(20, 60)), 3)
    for _ in range(400):
        x0, x1 = np.sort(rng.uniform(-10, shape[1] + 10, 2))
        y0, y1 = np.sort(rng.uniform(-10, shape[0] + 10, 2))
        if rng.random() < 0.3:  # lower or narrower than the outline
            x1 = x0 + rng.uniform(0, 4)
        if rng.random() < 0.3:
            y1 = y0 + rng.uniform(0, 4)
        xy = [x0, y0, x1, y1]
        got = np.zeros(shape, np.uint8)
        vis.draw_rectangle(got, xy, (255, 255, 255))
        np.testing.assert_array_equal(got, pil_rectangle(shape, xy), err_msg=str(xy))


def test_rectangle_refuses_what_pillow_refuses():
    img = np.zeros((8, 8, 3), np.uint8)
    for xy in ([5, 1, 4, 6], [1, 5, 6, 4]):
        with pytest.raises(ValueError) as ours:
            vis.draw_rectangle(img, xy, (1, 2, 3))
        with pytest.raises(ValueError) as theirs:
            pil_rectangle(img.shape, xy)
        assert str(ours.value) == str(theirs.value)


def seeded_detections(seed, n=10):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (n, 2))
    s = rng.uniform(0.02, 0.6, (n, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], 1).astype(np.float32)  # ymin, xmin, ymax, xmax
    return boxes, rng.integers(0, 21, n), rng.uniform(size=n).astype(np.float32)


@pytest.mark.parametrize("seed,hw", [(0, (120, 160)), (1, (320, 320)), (2, (37, 53))])
def test_boxes_equal_pillows_outside_the_captions(seed, hw):
    h, w = hw
    image01 = np.random.default_rng(seed + 10).uniform(size=(h, w, 3)).astype(np.float32)
    boxes, labels, scores = seeded_detections(seed)
    got = vis.draw_boxes(image01, boxes, labels, scores)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    ref = Image.fromarray((np.clip(image01, 0, 1) * 255).astype(np.uint8))
    draw = ImageDraw.Draw(ref)
    colors = vis.class_colors(len(NAMES))
    outside = np.ones((h, w), bool)
    for i, label in enumerate(labels):
        if label <= 0:
            continue
        ymin, xmin, ymax, xmax = boxes[i]
        draw.rectangle([xmin * w, ymin * h, xmax * w, ymax * h], outline=colors[label], width=2)
        x0, y0, x1, y1 = vis.caption_box(xmin * w + 2, ymin * h + 2, vis.caption(int(label), scores[i], NAMES))
        outside[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = False
    assert outside.sum() > 0.25 * h * w
    np.testing.assert_array_equal(got[outside], np.asarray(ref)[outside])


def test_captions_in_class_colours_from_the_font():
    image01 = np.zeros((60, 160, 3), np.float32)
    boxes = np.array([[0.1, 0.05, 0.9, 0.95]], np.float32)
    got = vis.draw_boxes(image01, boxes, np.array([15]), np.array([0.875]))
    text = vis.caption(15, 0.875, NAMES)
    assert text == "person 0.88"
    x0, y0, x1, y1 = vis.caption_box(0.05 * 160 + 2, 0.1 * 60 + 2, text)
    cell = got[y0:y1, x0:x1]
    color = np.array(vis.class_colors(21)[15], np.uint8)
    lit = (cell != 0).any(-1)
    assert lit.sum() > 40 and (cell[lit] == color).all()
    ink = np.zeros((y1 - y0, x1 - x0), bool)
    for i, ch in enumerate(text):
        ink[:7, 6 * i:6 * i + 5] = vis._glyph(ch)
    np.testing.assert_array_equal(lit, ink)
    assert set("".join(NAMES) + "0123456789. ") <= set(vis.FONT)


@pytest.mark.parametrize("seed", [0, 1])
def test_saved_picture_is_pillows_jpeg_of_the_drawing(seed, tmp_path):
    image01 = np.random.default_rng(seed).uniform(size=(75, 101, 3)).astype(np.float32)
    boxes, labels, scores = seeded_detections(seed + 5)
    path = vis.save_image_with_boxes(image01, boxes, labels, scores, directory=str(tmp_path), index=7)
    assert path == str(tmp_path / "7.jpg")
    buf = io.BytesIO()
    Image.fromarray(vis.draw_boxes(image01, boxes, labels, scores)).save(buf, format="JPEG")
    assert Path(path).read_bytes() == buf.getvalue()


def test_pictures_need_no_pil_or_cv2(tmp_path):
    code = "\n".join([
        "import sys",
        "sys.modules['PIL'] = sys.modules['cv2'] = None",
        "import numpy as np",
        "from ron_tensorflow_tpu_torch.data.decode import decode_image",
        "from ron_tensorflow_tpu_torch.utils.tensorboard import encode_png",
        "from ron_tensorflow_tpu_torch.utils.visualization import save_image_with_boxes",
        "img = np.random.default_rng(0).uniform(size=(40, 60, 3))",
        f"path = save_image_with_boxes(img, np.array([[0.1, 0.2, 0.8, 0.9]]), np.array([3]), np.array([0.5]),"
        f" directory={str(tmp_path)!r}, index=0)",
        "pic = decode_image(open(path, 'rb').read())",
        "assert pic.shape == (40, 60, 3)",
        "assert decode_image(encode_png(pic)).tolist() == pic.tolist()",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
