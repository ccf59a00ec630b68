"""Preprocessing: VGG whitening, the eval warp resize and the RON and SSD
train augmentations.

Port of `ron_tensorflow_tpu/data/preprocess.py`, for a whole batch at once
(per-image warp matrices [B, h, H] and [B, w, W], no loop over the images):

- 'ron' (ref: preprocessing/ssd_vgg_preprocessing.py:297-356
  `ron_preprocess_for_train`, preprocessing/tf_image.py:310-467): random
  expand (p 0.5 onto a 2x mean-colour canvas), a min-IoU random patch
  chosen from 16 candidates (each size from up to 5 aspect attempts),
  horizontal flip, one separable bilinear warp from the working canvas;
- 'ssd' (ref: ssd_vgg_preprocessing.py:169-295): a crop that covers at
  least a quarter of some gt box, chosen from 16 candidates (aspect and
  area drawn), the boxes mapped to the crop unclipped and kept by their
  overlap with it, horizontal flip, the warp, and the colour distortion;
- then whitening. `distort_color` (ref: ssd_vgg_preprocessing.py:97-166):
  brightness, saturation, hue (a YIQ rotation) and contrast in one of four
  orders, then a clip to [0, 1]. `color_distort=None` applies it for 'ssd'
  and not for 'ron', whose reference computes it and discards the result
  (ref: ssd_vgg_preprocessing.py:348).

The random draws are split from their use: `draw_augment` makes them from a
`torch.Generator`, `apply_augment` uses them, so that a test can hand both
sides JAX's draws (`AugmentDraws`, `SsdAugmentDraws`, `ColorDraws`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import boxes as boxops
from ..parallel.multihost import take_rows
from .resize import tf1_bilinear_resize

# VGG means, RGB order (ref: ssd_vgg_preprocessing.py:41-44).
VGG_MEANS = (123.0, 117.0, 104.0)


def whiten(image01: torch.Tensor) -> torch.Tensor:
    """[0,1] float image -> VGG-whitened pixels (scale x255, subtract the
    means; ref: ssd_vgg_preprocessing.py:47-55)."""
    means = torch.tensor(VGG_MEANS, dtype=image01.dtype, device=image01.device)
    return image01 * 255.0 - means


def unwhiten(image: torch.Tensor) -> torch.Tensor:
    means = torch.tensor(VGG_MEANS, dtype=image.dtype, device=image.device)
    return (image + means) / 255.0


def whiten_np(image01):
    """Host (numpy) version of `whiten` for input-pipeline code: float32."""
    import numpy as np

    return image01.astype(np.float32) * 255.0 - np.asarray(VGG_MEANS, np.float32)


def eval_preprocess(image01: torch.Tensor, out_shape: Tuple[int, int] = (320, 320)):
    """Whiten + warp resize with TF1 legacy-bilinear numerics (the
    reference's default Resize.WARP_RESIZE). image01 [H, W, 3] -> (the
    whitened [oh, ow, 3] image, the full-image reference box used to
    un-resize detections)."""
    img = tf1_bilinear_resize(image01, out_shape)
    bbox_img = torch.tensor([0.0, 0.0, 1.0, 1.0], device=img.device)
    return whiten(img), bbox_img


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """`preprocess.py:70-92`: the 'ron' or the 'ssd' chain."""

    variant: str = "ron"
    out_shape: Tuple[int, int] = (320, 320)
    expand_prob: float = 0.5
    expand_ratio: float = 2.0
    patch_candidates: int = 16  # replaces the reference's 10/200-attempt retry loops
    aspect_attempts: int = 5  # ref: tf_image.py:312-331 sample_width_height
    min_ious: Tuple[float, ...] = (0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
    flip_prob: float = 0.5
    # None = the variant's reference behaviour: RON discards the distortion, SSD applies it
    color_distort: Optional[bool] = None
    # SSD crop constants (ref: ssd_vgg_preprocessing.py:35-37)
    min_object_covered: float = 0.25
    crop_aspect_range: Tuple[float, float] = (0.6, 1.67)
    crop_area_range: Tuple[float, float] = (0.1, 1.0)
    crop_overlap_threshold: float = 0.5


class ColorDraws(NamedTuple):
    """`distort_color`'s draws for B images (preprocess.py:368-424): the
    ordering, then each distortion's value, which JAX draws from the key of
    the position the ordering gives it."""

    ordering: torch.Tensor  # [B] int in [0, 4): one of COLOR_ORDERS (key 0)
    brightness: torch.Tensor  # [B] U[-32/255, 32/255): added
    saturation: torch.Tensor  # [B] U[0.5, 1.5): factor about the pixel's grey
    hue: torch.Tensor  # [B] U[-0.2, 0.2): turns of the YIQ rotation
    contrast: torch.Tensor  # [B] U[0.5, 1.5): factor about the channel means


class AugmentDraws(NamedTuple):
    """The RON chain's random draws for B images, as `train_augment` draws
    them from `split(rng, 8)` (preprocess.py:164-193); `color` (key 7) only
    with `color_distort=True`."""

    expand: torch.Tensor  # [B] U[0, 1): expand where < expand_prob (key 0)
    oy: torch.Tensor  # [B] U[0, ratio - 1): the image's offset on the canvas (key 1)
    ox: torch.Tensor  # [B] (key 2)
    min_iou: torch.Tensor  # [B] one of config.min_ious, uniformly (key 3)
    wh: torch.Tensor  # [B, candidates, attempts, 2] U[0.1, 0.999): patch (w, h) (key 4)
    patch: torch.Tensor  # [B, candidates, 2] U[0, 1): patch (y, x) offsets (key 5)
    flip: torch.Tensor  # [B] U[0, 1): flip where < flip_prob (key 6)
    color: Optional[ColorDraws] = None


class SsdAugmentDraws(NamedTuple):
    """The SSD chain's random draws for B images, as `_ssd_train_augment`
    draws them from `split(rng, 6)` (preprocess.py:273-330)."""

    aspect: torch.Tensor  # [B, candidates] U(crop_aspect_range) (key 0)
    area: torch.Tensor  # [B, candidates] U(crop_area_range) (key 1)
    offset: torch.Tensor  # [B, candidates, 2] U[0, 1): crop (y, x) offsets (key 2)
    flip: torch.Tensor  # [B] U[0, 1): flip where < flip_prob (key 3)
    color: Optional[ColorDraws] = None  # key 4, unless color_distort is False


def _check_variant(cfg: PreprocessConfig):
    if cfg.variant not in ("ron", "ssd"):
        raise ValueError(f"unknown augment variant {cfg.variant!r}")


def _distorts(cfg: PreprocessConfig) -> bool:
    """Whether the chain applies the colour distortion: as asked, or by
    default for 'ssd' only."""
    return cfg.color_distort if cfg.color_distort is not None else cfg.variant == "ssd"


def _draws_to(draws, device):
    """A draws tuple (nested tuples and None included) on `device`."""
    if draws is None:
        return None
    if isinstance(draws, tuple):
        return type(draws)(*(_draws_to(d, device) for d in draws))
    return torch.as_tensor(draws, device=device)


def draw_color(generator: torch.Generator, batch: int) -> ColorDraws:
    """`distort_color`'s draws for `batch` images, on the generator's device."""
    dev = generator.device

    def uniform(lo, hi):
        return torch.rand(batch, generator=generator, device=dev) * (hi - lo) + lo

    ordering = torch.randint(len(COLOR_ORDERS), (batch,), generator=generator, device=dev)
    return ColorDraws(ordering, uniform(-32.0 / 255.0, 32.0 / 255.0), uniform(0.5, 1.5), uniform(-0.2, 0.2),
                      uniform(0.5, 1.5))


def draw_augment(generator: torch.Generator, batch: int, cfg: PreprocessConfig = PreprocessConfig()):
    """The draws of `batch` images, on the generator's device: an
    `AugmentDraws` for 'ron', an `SsdAugmentDraws` for 'ssd'."""
    _check_variant(cfg)
    k, a, dev = cfg.patch_candidates, cfg.aspect_attempts, generator.device

    def uniform(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    if cfg.variant == "ssd":
        aspect = uniform(batch, k, lo=cfg.crop_aspect_range[0], hi=cfg.crop_aspect_range[1])
        area = uniform(batch, k, lo=cfg.crop_area_range[0], hi=cfg.crop_area_range[1])
        offset, flip = uniform(batch, k, 2), uniform(batch)
        return SsdAugmentDraws(aspect, area, offset, flip, draw_color(generator, batch) if _distorts(cfg) else None)
    r = cfg.expand_ratio
    expand, oy, ox = uniform(batch), uniform(batch, hi=r - 1.0), uniform(batch, hi=r - 1.0)
    pick = torch.randint(len(cfg.min_ious), (batch,), generator=generator, device=dev)
    min_iou = torch.tensor(cfg.min_ious, dtype=torch.float32, device=dev)[pick]
    wh = uniform(batch, k, a, 2, lo=0.1, hi=0.999)
    patch, flip = uniform(batch, k, 2), uniform(batch)
    return AugmentDraws(expand, oy, ox, min_iou, wh, patch, flip,
                        draw_color(generator, batch) if _distorts(cfg) else None)


def _bilinear_warp_separable(image, ys, xs, fill):
    """Axis-aligned bilinear warp as two batched matmuls (preprocess.py:95-132):
    out = Wy @ image @ Wx^T with tent-kernel rows, the edge pixels given
    the tent mass that falls outside, and the output blended to `fill` by
    the share of its mass inside the source.

    image [B, H, W, 3]; ys [B, h], xs [B, w] normalized sample centres;
    fill [B, 3] -> [B, h, w, 3]."""
    h_src, w_src = image.shape[1], image.shape[2]
    fy = ys * h_src - 0.5  # pixel centres of tf.image.resize(align_corners=False)
    fx = xs * w_src - 0.5
    ky = torch.arange(h_src, dtype=torch.float32, device=image.device)
    kx = torch.arange(w_src, dtype=torch.float32, device=image.device)
    wy = torch.clamp(1.0 - (fy[..., None] - ky).abs(), min=0.0)  # [B, h, H]
    wx = torch.clamp(1.0 - (fx[..., None] - kx).abs(), min=0.0)  # [B, w, W]
    wy[..., 0] += torch.clamp(-fy, 0.0, 1.0)
    wy[..., -1] += torch.clamp(fy - (h_src - 1), 0.0, 1.0)
    wx[..., 0] += torch.clamp(-fx, 0.0, 1.0)
    wx[..., -1] += torch.clamp(fx - (w_src - 1), 0.0, 1.0)

    tmp = torch.einsum("bik,bklc->bilc", wy, image)  # [B, h, W, 3]
    out = torch.einsum("bjl,bilc->bijc", wx, tmp)  # [B, h, w, 3]

    cov = torch.clamp(wy.sum(-1), 0.0, 1.0)[:, :, None] * torch.clamp(wx.sum(-1), 0.0, 1.0)[:, None, :]
    outside = ((ys < 0.0) | (ys > 1.0))[:, :, None] | ((xs < 0.0) | (xs > 1.0))[:, None, :]
    cov = torch.where(outside, 0.0, cov)[..., None]
    return out * cov + fill[:, None, None, :] * (1.0 - cov)


def _roi_jaccard(roi, boxes):
    """IoU of rois [..., 4] with boxes [..., 4] (broadcast), 0 where the
    union is empty (ref: tf_image.py:333-345)."""
    ymin = torch.maximum(roi[..., 0], boxes[..., 0])
    xmin = torch.maximum(roi[..., 1], boxes[..., 1])
    ymax = torch.minimum(roi[..., 2], boxes[..., 2])
    xmax = torch.minimum(roi[..., 3], boxes[..., 3])
    inter = torch.clamp(ymax - ymin, min=0.0) * torch.clamp(xmax - xmin, min=0.0)
    union = ((roi[..., 2] - roi[..., 0]) * (roi[..., 3] - roi[..., 1])
             + (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1]) - inter)
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def _first_true(mask):
    """Index of the first True along the last axis (0 where none is)."""
    return mask.to(torch.uint8).argmax(dim=-1)


def apply_augment(draws, images01, boxes, labels, valid, cfg: PreprocessConfig = PreprocessConfig()):
    """The train augmentation of a batch with the given draws (`draw_augment`'s
    for the config's variant; `train_augment`, preprocess.py:151-343).

    images01 [B, H0, W0, 3] float in [0, 1] (the working canvas); boxes
    [B, G, 4] normalized corners; labels [B, G]; valid [B, G] bool.
    Returns (whitened images [B, out_h, out_w, 3], boxes [B, G, 4] in the
    patch's frame (clipped for 'ron', not for 'ssd'), labels, valid)."""
    _check_variant(cfg)
    dev = images01.device
    d = _draws_to(draws, dev)
    valid = valid.bool()
    if cfg.variant == "ssd":
        return _apply_ssd_augment(d, images01, boxes, labels, valid, cfg)
    mean_color = images01.mean(dim=(1, 2))  # [B, 3]

    # random expand (ref: tf_image.py:440-467): the image at (oy, ox)/r of the canvas
    do_expand = d.expand < cfg.expand_prob
    r = cfg.expand_ratio
    offset = torch.where(do_expand[:, None], torch.stack([d.oy, d.ox, d.oy, d.ox], -1) / r, 0.0)  # [B, 4]
    scale = torch.where(do_expand, torch.tensor(1.0 / r, device=dev), torch.tensor(1.0, device=dev))  # [B]
    boxes_c = boxes * scale[:, None, None] + offset[:, None, :]

    # random patch (ref: tf_image.py:310-438): the first good aspect attempt,
    # else the last draw; the first candidate that takes a gt centre and
    # overlaps every taken gt by min_iou, else the whole canvas
    wh = d.wh
    good = (wh[..., 0] <= 2.0 * wh[..., 1]) & (wh[..., 1] <= 2.0 * wh[..., 0])  # [B, k, A]
    pick = torch.where(good.any(-1), _first_true(good), cfg.aspect_attempts - 1)[..., None]
    wsel = wh[..., 0].gather(-1, pick)[..., 0]
    hsel = wh[..., 1].gather(-1, pick)[..., 0]
    y0 = d.patch[..., 0] * (1.0 - hsel)
    x0 = d.patch[..., 1] * (1.0 - wsel)
    rois = torch.stack([y0, x0, y0 + hsel, x0 + wsel], dim=-1)  # [B, k, 4]

    cy = ((boxes_c[..., 0] + boxes_c[..., 2]) / 2.0)[:, None, :]  # [B, 1, G]
    cx = ((boxes_c[..., 1] + boxes_c[..., 3]) / 2.0)[:, None, :]
    center_in = ((cy > rois[..., 0:1]) & (cx > rois[..., 1:2]) & (cy < rois[..., 2:3]) & (cx < rois[..., 3:4])
                 & valid[:, None, :])  # [B, k, G]
    iou = _roi_jaccard(rois[:, :, None, :], boxes_c[:, None, :, :])  # [B, k, G]
    ok_overlap = torch.where(center_in, iou >= d.min_iou[:, None, None], True).all(-1)
    cand_valid = center_in.any(-1) & ok_overlap  # [B, k]
    any_valid = cand_valid.any(-1)
    chosen = _first_true(cand_valid)
    whole = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    roi = torch.where(any_valid[:, None], rois[torch.arange(len(rois), device=dev), chosen], whole)  # [B, 4]
    keep = torch.where(any_valid[:, None], center_in[torch.arange(len(rois), device=dev), chosen], valid)

    # boxes in the patch's frame, clipped (ref: tf_image.py:402-427)
    rh = roi[:, 2] - roi[:, 0]
    rw = roi[:, 3] - roi[:, 1]
    origin = torch.stack([roi[:, 0], roi[:, 1], roi[:, 0], roi[:, 1]], -1)[:, None, :]
    b = torch.clamp((boxes_c - origin) / torch.stack([rh, rw, rh, rw], -1)[:, None, :], 0.0, 1.0)
    new_valid = keep & valid

    # random flip (ref: tf_image.py:284-308)
    do_flip = d.flip < cfg.flip_prob
    b = torch.where(do_flip[:, None, None], boxops.flip_left_right(b), b)

    # one warp: output pixel -> patch -> canvas -> source image, per axis
    out_h, out_w = cfg.out_shape
    gy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h
    gx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w
    gx = torch.where(do_flip[:, None], 1.0 - gx, gx)  # [B, out_w]
    sy = (roi[:, 0:1] + gy * rh[:, None] - offset[:, 0:1]) / scale[:, None]
    sx = (roi[:, 1:2] + gx * rw[:, None] - offset[:, 1:2]) / scale[:, None]
    out = _bilinear_warp_separable(images01, sy, sx, mean_color)
    if _distorts(cfg):
        out = distort_color(d.color, out)
    return whiten(out), b, labels, new_valid


def _apply_ssd_augment(d: SsdAugmentDraws, images01, boxes, labels, valid, cfg: PreprocessConfig):
    """The SSD chain (`_ssd_train_augment`, preprocess.py:250-343): the first
    candidate crop that fits in the image and covers at least
    `min_object_covered` of some valid gt box's area, else the whole image;
    the boxes in the crop's frame, unclipped, kept by `filter_overlap_mask`;
    flip; the warp; the colour distortion."""
    dev = images01.device
    mean_color = images01.mean(dim=(1, 2))  # [B, 3]
    h = torch.sqrt(d.area / d.aspect)  # [B, k]
    w = torch.sqrt(d.area * d.aspect)
    fits = (h <= 1.0) & (w <= 1.0)
    y0 = d.offset[..., 0] * torch.clamp(1.0 - h, min=0.0)
    x0 = d.offset[..., 1] * torch.clamp(1.0 - w, min=0.0)
    rois = torch.stack([y0, x0, y0 + h, x0 + w], dim=-1)  # [B, k, 4]

    # the share of each gt box's area inside each candidate, [B, k, G]
    r, g = rois[:, :, None, :], boxes[:, None, :, :]
    iy = torch.clamp(torch.minimum(r[..., 2], g[..., 2]) - torch.maximum(r[..., 0], g[..., 0]), min=0.0)
    ix = torch.clamp(torch.minimum(r[..., 3], g[..., 3]) - torch.maximum(r[..., 1], g[..., 1]), min=0.0)
    cover = iy * ix / torch.clamp(boxops.areas(boxes), min=1e-8)[:, None, :]
    covered = ((cover >= cfg.min_object_covered) & valid[:, None, :]).any(-1)
    cand_valid = fits & covered  # [B, k]
    rows = torch.arange(len(rois), device=dev)
    whole = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    roi = torch.where(cand_valid.any(-1)[:, None], rois[rows, _first_true(cand_valid)], whole)  # [B, 4]
    rh = roi[:, 2] - roi[:, 0]
    rw = roi[:, 3] - roi[:, 1]

    b = boxops.resize_to_ref(roi, boxes)
    new_valid = boxops.filter_overlap_mask(b, valid, cfg.crop_overlap_threshold)
    do_flip = d.flip < cfg.flip_prob
    b = torch.where(do_flip[:, None, None], boxops.flip_left_right(b), b)

    out_h, out_w = cfg.out_shape
    gy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h
    gx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w
    gx = torch.where(do_flip[:, None], 1.0 - gx, gx)  # [B, out_w]
    out = _bilinear_warp_separable(images01, roi[:, 0:1] + gy * rh[:, None], roi[:, 1:2] + gx * rw[:, None],
                                   mean_color)
    if _distorts(cfg):
        out = distort_color(d.color, out)
    return whiten(out), b, labels, new_valid


# RGB <-> YIQ as row-vector maps (x @ M) of the hue rotation (preprocess.py:385-402)
_RGB_TO_YIQ = ((0.299, 0.596, 0.211), (0.587, -0.274, -0.523), (0.114, -0.322, 0.312))
_YIQ_TO_RGB = ((1.0, 1.0, 1.0), (0.956, -0.272, -1.106), (0.621, -0.647, 1.703))


def _mm(a, b):
    """a @ b over the last two axes as products and a sum: exact float32
    whatever the caller's TF32 matmul flag."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _brightness(m, c, mean0, delta):
    return m, c + delta[:, None]


def _saturation(m, c, mean0, factor):
    """gray + f (x - gray), gray the channels' mean: x @ (f I + (1 - f) / 3)."""
    f = factor[:, None, None]
    s = f * torch.eye(3, device=m.device) + (1 - f) / 3
    return _mm(m, s), _mm(c[:, None], s)[:, 0]


def _hue(m, c, mean0, delta):
    """A phase shift of the YIQ chroma by delta turns."""
    d = delta * 2 * math.pi
    cosd, sind, zero, one = torch.cos(d), torch.sin(d), torch.zeros_like(d), torch.ones_like(d)
    rot = torch.stack([torch.stack([one, zero, zero], -1), torch.stack([zero, cosd, sind], -1),
                       torch.stack([zero, -sind, cosd], -1)], -2)
    h = _mm(_mm(torch.tensor(_RGB_TO_YIQ, device=m.device), rot), torch.tensor(_YIQ_TO_RGB, device=m.device))
    return _mm(m, h), _mm(c[:, None], h)[:, 0]


def _contrast(m, c, mean0, factor):
    """mean + f (x - mean), mean the image's per-channel mean, which is
    mean0 @ m + c for the image x @ m + c."""
    f = factor[:, None]
    return m * f[..., None], c + (1 - f) * _mm(mean0[:, None], m)[:, 0]


# distort_color's four orders of (brightness, saturation, hue, contrast) by their
# index in ColorDraws' fields (preprocess.py:410-415)
COLOR_ORDERS = ((1, 2, 3, 4), (2, 1, 4, 3), (4, 3, 1, 2), (3, 2, 4, 1))
_COLOR_FNS = {1: _brightness, 2: _saturation, 3: _hue, 4: _contrast}


def distort_color(draws: ColorDraws, image01):
    """The four-way ordered colour distortion of a batch [B, H, W, 3] in
    [0, 1], each image in its own order with its own values, clipped to
    [0, 1] after (preprocess.py:368-424). Each distortion is affine in RGB
    and JAX clips only at the end, so an image's whole chain is one map
    x @ m + c: composed in the image's order on [B, 3, 3] tensors, then
    applied in one pass. No host round trip."""
    b = image01.shape[0]
    orders = torch.tensor(COLOR_ORDERS, device=image01.device)[draws.ordering]  # [B, 4]
    mean0 = image01.mean(dim=(1, 2))
    m = torch.eye(3, device=image01.device).expand(b, 3, 3)
    c = torch.zeros(b, 3, device=image01.device)
    rows = torch.arange(b, device=image01.device)
    for pos in range(4):
        maps = [fn(m, c, mean0, draws[field]) for field, fn in _COLOR_FNS.items()]
        pick = orders[:, pos] - 1  # _COLOR_FNS' keys are 1..4
        m, c = torch.stack([mk for mk, _ in maps])[pick, rows], torch.stack([ck for _, ck in maps])[pick, rows]
    out = _mm(image01[..., None, :], m[:, None, None])[..., 0, :] + c[:, None, None]
    return torch.clamp(out, 0.0, 1.0)


def train_augment_batch(generator: torch.Generator, images01, boxes, labels, valid,
                        cfg: PreprocessConfig = PreprocessConfig(), rows=None):
    """Draw, then apply, for a batch: see `draw_augment`, `apply_augment`.
    rows: (offset, global batch) when the batch is a rank's rows of a global
    one: the draws are made for the whole global batch and cut to these
    rows, so that the rows augment as they would in one process."""
    if rows is None:
        return apply_augment(draw_augment(generator, images01.shape[0], cfg), images01, boxes, labels, valid, cfg)
    draws = take_rows(draw_augment(generator, rows[1], cfg), rows[0], images01.shape[0])
    return apply_augment(draws, images01, boxes, labels, valid, cfg)


def train_augment(generator: torch.Generator, image01, boxes, labels, valid,
                  cfg: PreprocessConfig = PreprocessConfig()):
    """One image: [H0, W0, 3], [G, 4], [G], [G] (a batch of one)."""
    out = train_augment_batch(generator, image01[None], boxes[None], labels[None], valid[None], cfg)
    return tuple(t[0] for t in out)
