"""Preprocessing: VGG whitening, the eval warp resize and the RON train
augmentation.

Port of `ron_tensorflow_tpu/data/preprocess.py` (ref:
preprocessing/ssd_vgg_preprocessing.py:297-356 `ron_preprocess_for_train`,
preprocessing/tf_image.py:310-467): random expand (p 0.5 onto a 2x
mean-colour canvas), a min-IoU random patch chosen from 16 candidates (each
size from up to 5 aspect attempts), horizontal flip, one separable bilinear
warp from the working canvas and whitening, for a whole batch at once (per
image warp matrices [B, h, H] and [B, w, W], no loop over the images).

The random draws are split from their use: `draw_augment` makes them from a
`torch.Generator`, `apply_augment` uses them, so that a test can hand both
sides JAX's draws. The RON chain draws seven values an image; JAX splits
eight keys, the eighth feeding the colour distortion, which RON computes
and then discards (ref: ssd_vgg_preprocessing.py:348), so it is off here
as the JAX default (`color_distort=None`) has it. The SSD variant and
`distort_color` wait for the SSD slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

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
    """`preprocess.py:70-92`. Only the 'ron' variant is ported."""

    variant: str = "ron"
    out_shape: Tuple[int, int] = (320, 320)
    expand_prob: float = 0.5
    expand_ratio: float = 2.0
    patch_candidates: int = 16  # replaces the reference's 10/200-attempt retry loops
    aspect_attempts: int = 5  # ref: tf_image.py:312-331 sample_width_height
    min_ious: Tuple[float, ...] = (0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
    flip_prob: float = 0.5
    # None = the variant's reference behaviour: RON discards the distortion
    color_distort: Optional[bool] = None
    # SSD crop constants (ref: ssd_vgg_preprocessing.py:35-37), for the SSD slice
    min_object_covered: float = 0.25
    crop_aspect_range: Tuple[float, float] = (0.6, 1.67)
    crop_area_range: Tuple[float, float] = (0.1, 1.0)
    crop_overlap_threshold: float = 0.5


class AugmentDraws(NamedTuple):
    """The RON chain's random draws for B images, as `train_augment` draws
    them from `split(rng, 8)` (preprocess.py:164-193)."""

    expand: torch.Tensor  # [B] U[0, 1): expand where < expand_prob (key 0)
    oy: torch.Tensor  # [B] U[0, ratio - 1): the image's offset on the canvas (key 1)
    ox: torch.Tensor  # [B] (key 2)
    min_iou: torch.Tensor  # [B] one of config.min_ious, uniformly (key 3)
    wh: torch.Tensor  # [B, candidates, attempts, 2] U[0.1, 0.999): patch (w, h) (key 4)
    patch: torch.Tensor  # [B, candidates, 2] U[0, 1): patch (y, x) offsets (key 5)
    flip: torch.Tensor  # [B] U[0, 1): flip where < flip_prob (key 6)


def _check_variant(cfg: PreprocessConfig):
    if cfg.variant != "ron":
        raise NotImplementedError(f"augment variant {cfg.variant!r}: the SSD crop waits for the SSD slice "
                                  "(ROADMAP Queue 1 item 2)")
    if cfg.color_distort:
        raise NotImplementedError("color_distort: the colour distortion waits for the SSD slice")


def draw_augment(generator: torch.Generator, batch: int, cfg: PreprocessConfig = PreprocessConfig()) -> AugmentDraws:
    """The draws of `batch` images, on the generator's device."""
    _check_variant(cfg)
    k, a, dev = cfg.patch_candidates, cfg.aspect_attempts, generator.device

    def uniform(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    r = cfg.expand_ratio
    expand, oy, ox = uniform(batch), uniform(batch, hi=r - 1.0), uniform(batch, hi=r - 1.0)
    pick = torch.randint(len(cfg.min_ious), (batch,), generator=generator, device=dev)
    min_iou = torch.tensor(cfg.min_ious, dtype=torch.float32, device=dev)[pick]
    wh = uniform(batch, k, a, 2, lo=0.1, hi=0.999)
    return AugmentDraws(expand, oy, ox, min_iou, wh, uniform(batch, k, 2), uniform(batch))


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


def apply_augment(draws: AugmentDraws, images01, boxes, labels, valid, cfg: PreprocessConfig = PreprocessConfig()):
    """The RON train augmentation of a batch with the given draws
    (`train_augment`, preprocess.py:151-247).

    images01 [B, H0, W0, 3] float in [0, 1] (the working canvas); boxes
    [B, G, 4] normalized corners; labels [B, G]; valid [B, G] bool.
    Returns (whitened images [B, out_h, out_w, 3], boxes [B, G, 4] in the
    patch's frame, clipped, labels, valid)."""
    _check_variant(cfg)
    dev = images01.device
    d = AugmentDraws(*(t.to(dev) for t in draws))
    mean_color = images01.mean(dim=(1, 2))  # [B, 3]
    valid = valid.bool()

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
    flipped = torch.stack([b[..., 0], 1.0 - b[..., 3], b[..., 2], 1.0 - b[..., 1]], dim=-1)
    b = torch.where(do_flip[:, None, None], flipped, b)

    # one warp: output pixel -> patch -> canvas -> source image, per axis
    out_h, out_w = cfg.out_shape
    gy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h
    gx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w
    gx = torch.where(do_flip[:, None], 1.0 - gx, gx)  # [B, out_w]
    sy = (roi[:, 0:1] + gy * rh[:, None] - offset[:, 0:1]) / scale[:, None]
    sx = (roi[:, 1:2] + gx * rw[:, None] - offset[:, 1:2]) / scale[:, None]
    out = _bilinear_warp_separable(images01, sy, sx, mean_color)
    return whiten(out), b, labels, new_valid


def train_augment_batch(generator: torch.Generator, images01, boxes, labels, valid,
                        cfg: PreprocessConfig = PreprocessConfig()):
    """Draw, then apply, for a batch: see `apply_augment`."""
    return apply_augment(draw_augment(generator, images01.shape[0], cfg), images01, boxes, labels, valid, cfg)


def train_augment(generator: torch.Generator, image01, boxes, labels, valid,
                  cfg: PreprocessConfig = PreprocessConfig()):
    """One image: [H0, W0, 3], [G, 4], [G], [G] (a batch of one)."""
    out = train_augment_batch(generator, image01[None], boxes[None], labels[None], valid[None], cfg)
    return tuple(t[0] for t in out)
