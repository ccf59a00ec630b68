"""Box drawing / debug image dumps, in numpy: no PIL.

Port of `ron_tensorflow_tpu/utils/visualization.py`, which draws with PIL's
ImageDraw and saves through PIL (ref: draw_toolbox.py:48-101,
notebooks/visualization.py:86-114, eval_ron_network.py:240-247 the
`save_image_with_bbox` py_func debug hook). Here:

- the outlines fill the pixels that Pillow's `ImageDraw.rectangle(xy,
  outline=color, width=2)` fills for the same float corners: each corner
  cut toward zero to an int (the C cast of `_draw_rectangle`), then `width`
  horizontal rows from each of y0 and y1 inward, clipped to the image, and
  `width` vertical lines from each of x0 and x1 inward, each drawn as
  Pillow's line drawer steps from y0 + width toward y1 - width + 1, that end
  excluded, so a rectangle lower than 2 * width rows also paints a row or
  two outside its corners, as Pillow's does; a corner pair with x1 < x0 or
  y1 < y0 raises ValueError, as Pillow does;
- the captions ("<class> <score>") are drawn in the class colour from a
  5x7 bitmap font kept below as data, at the same anchor as JAX's
  `draw.text` (2 px right of and below the top-left corner), one 6 x 8 px
  cell a character; they are not PIL's glyphs;
- `save_image_with_boxes` writes `<index>.jpg` with the port's JPEG encoder
  (`data/jpeg.py::encode_jpeg`) at Pillow's defaults (quality 75, 4:2:0),
  the bytes Pillow's `save` writes for the same array.
"""

from __future__ import annotations

import colorsys
import os
from typing import Optional, Sequence

import numpy as np

from ..data.jpeg import encode_jpeg
from ..data.voc import VOC_CLASSES

OUTLINE_WIDTH = 2
JPEG_QUALITY = 75  # Pillow's default
GLYPH_W, GLYPH_H = 5, 7
CELL_W, CELL_H = GLYPH_W + 1, GLYPH_H + 1
# 5x7 glyphs: 7 rows of 5 pixels, each row a hex byte, bit 4 the leftmost pixel
FONT = {
    " ": "00000000000000", "?": "0E110102040004", ".": "00000000000C0C", "-": "0000001F000000", "_": "0000000000001F",
    ":": "000C0C000C0C00", "0": "0E11131519110E", "1": "040C040404040E", "2": "0E11010204081F", "3": "1F02040201110E",
    "4": "02060A121F0202", "5": "1F101E0101110E", "6": "0608101E11110E", "7": "1F010204080808", "8": "0E11110E11110E",
    "9": "0E11110F01020C", "a": "00000E010F110F", "b": "1010161911111E", "c": "00000E1010110E", "d": "01010D1311110F",
    "e": "00000E111F100E", "f": "0609081C080808", "g": "000F11110F010E", "h": "10101619111111", "i": "04000C0404040E",
    "j": "0200060202120C", "k": "10101214181412", "l": "0C04040404040E", "m": "00001A15151111", "n": "00001619111111",
    "o": "00000E1111110E", "p": "00001E111E1010", "q": "00000D130F0101", "r": "00001619101010", "s": "00000E100E011E",
    "t": "08081C08080906", "u": "0000111111130D", "v": "00001111110A04", "w": "0000111115150A", "x": "0000110A040A11",
    "y": "000011110F010E", "z": "00001F0204081F", "A": "0E1111111F1111", "B": "1E11111E11111E", "C": "0E11101010110E",
    "D": "1C12111111121C", "E": "1F10101E10101F", "F": "1F10101E101010", "G": "0E11101711110F", "H": "1111111F111111",
    "I": "0E04040404040E", "J": "0702020202120C", "K": "11121418141211", "L": "1010101010101F", "M": "111B1515111111",
    "N": "11111915131111", "O": "0E11111111110E", "P": "1E11111E101010", "Q": "0E11111115120D", "R": "1E11111E141211",
    "S": "0F10100E01011E", "T": "1F040404040404", "U": "1111111111110E", "V": "11111111110A04", "W": "1111111515150A",
    "X": "11110A040A1111", "Y": "1111110A040404", "Z": "1F01020408101F",
}


def _glyph(ch: str) -> np.ndarray:
    """bool [7, 5] pixels of a character ('?' for one the font lacks)."""
    rows = bytes.fromhex(FONT.get(ch, FONT["?"]))
    return (np.frombuffer(rows, np.uint8)[:, None] >> np.arange(GLYPH_W - 1, -1, -1)) & 1 == 1


def class_colors(num_classes: int = 21):
    """Distinct hues per class (ref: draw_toolbox.py:29-45 colors_subselect)."""
    colors = []
    for i in range(num_classes):
        r, g, b = colorsys.hsv_to_rgb(i / max(num_classes, 1), 0.9, 0.9)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
    return colors


def draw_rectangle(img: np.ndarray, xy, color, width: int = OUTLINE_WIDTH) -> None:
    """Pillow's `ImageDraw.rectangle(xy, outline=color, width=width)` on
    img [H, W, 3] uint8, in place (see the module's docstring)."""
    if xy[2] < xy[0]:
        raise ValueError("x1 must be greater than or equal to x0")
    if xy[3] < xy[1]:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = (int(float(v)) for v in xy)
    h, w = img.shape[:2]
    width = max(width, 1)
    for i in range(width):
        for y in (y0 + i, y1 - i):
            if 0 <= y < h and max(x0, 0) <= min(x1, w - 1):
                img[y, max(x0, 0):min(x1, w - 1) + 1] = color
        start, stop = y0 + width, y1 - width + 1
        ys = np.arange(start, stop, 1 if stop >= start else -1)
        ys = ys[(ys >= 0) & (ys < h)]
        for x in (x1 - i, x0 + i):
            if 0 <= x < w:
                img[ys, x] = color


def caption_box(x: float, y: float, text: str):
    """(x0, y0, x1, y1), exclusive ends, of the cells `draw_text` fills for
    text anchored at (x, y)."""
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    return x0, y0, x0 + CELL_W * len(text), y0 + CELL_H


def draw_text(img: np.ndarray, x: float, y: float, text: str, color) -> None:
    """text from the bitmap font on img [H, W, 3] uint8 with its top-left
    cell at (x, y), in place, clipped to the image."""
    x0, y0, _, _ = caption_box(x, y, text)
    h, w = img.shape[:2]
    for i, ch in enumerate(text):
        ys, xs = np.nonzero(_glyph(ch))
        ys, xs = ys + y0, xs + x0 + CELL_W * i
        inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[inside], xs[inside]] = color


def caption(label: int, score, class_names: Sequence[str]) -> str:
    text = class_names[label] if label < len(class_names) else str(label)
    return text if score is None else text + f" {float(score):.2f}"


def draw_boxes(
    image01: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    scores: Optional[np.ndarray] = None,
    class_names: Sequence[str] = ("bg",) + VOC_CLASSES,
) -> np.ndarray:
    """image01 [H,W,3] float [0,1]; boxes [N,4] normalized corner.
    Returns the drawn picture, uint8 [H, W, 3] RGB."""
    img = (np.clip(image01, 0, 1) * 255).astype(np.uint8)
    h, w = image01.shape[:2]
    colors = class_colors(len(class_names))
    for i in range(len(boxes)):
        label = int(labels[i])
        if label <= 0:
            continue
        ymin, xmin, ymax, xmax = boxes[i]
        color = colors[label % len(colors)]
        draw_rectangle(img, [xmin * w, ymin * h, xmax * w, ymax * h], color)
        draw_text(img, xmin * w + 2, ymin * h + 2, caption(label, None if scores is None else scores[i], class_names),
                  color)
    return img


def save_image_with_boxes(
    image01, boxes, labels, scores=None, directory: str = "./Debug", index: int = 0
) -> str:
    """Debug dump like the reference's ./Debug/<n>.jpg hook."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{index}.jpg")
    picture = draw_boxes(np.asarray(image01), np.asarray(boxes), np.asarray(labels), scores)
    with open(path, "wb") as f:
        f.write(encode_jpeg(picture, JPEG_QUALITY))
    return path
