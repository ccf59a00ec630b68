"""Ground-truth encoding: joint all-layer dual-max anchor matching.

Port of `ron_tensorflow_tpu/ops/encode.py` (the reference's "big fix"
encoder, ref: nets/ssd_common.py:27-147, :337-414): the anchors of all
feature layers are matched jointly against a padded [G, 4] gt table with a
validity mask. The JAX encoder is written for one image and vmapped; here
every function takes the batch axis itself, [B, G, N] overlaps at once.

Match-state conventions (the reference's):
  label > 0   positive anchor (the matched gt's class)
  label == 0  negative (best IoU < ignore_threshold)
  label == -1 ignore (IoU in [ignore_threshold, positive_threshold))
and a gt -> anchor argmax override claims the best anchor of each valid gt
whatever the thresholds (ref: nets/ssd_common.py:66-75). `match_idx`
codes a negative anchor as -1 and an ignored one as -2.

Localization targets, in (cx, cy, w, h) order, `prior_scaling` indices 0/1
on x/y and 2/3 on w/h (encode.py:158-166):
  t = ((gcx-acx)/aw/s0, (gcy-acy)/ah/s1, log(gw/aw)/s2, log(gh/ah)/s3)
Unmatched anchors take 0 (their log runs on the anchor's own size).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .anchors import AnchorLayout
from .boxes import iou_matrix


class EncodedTargets(NamedTuple):
    """Per-anchor training targets, flat across all feature layers."""

    labels: torch.Tensor  # [..., N] int32: class id, 0 = negative, -1 = ignore
    locations: torch.Tensor  # [..., N, 4] float32 (cx, cy, w, h) regression targets
    scores: torch.Tensor  # [..., N] float32 IoU with the selected gt


def anchor_inside_mask(layout: AnchorLayout, img_shape: Tuple[int, int]) -> np.ndarray:
    """[N] mask of the anchors within `allowed_border` pixels of the image
    (ref: nets/ssd_common.py:112-115)."""
    c = layout.corners
    b = layout.allowed_borders
    h, w = float(img_shape[0]), float(img_shape[1])
    return (c[:, 0] >= -b / h) & (c[:, 1] >= -b / w) & (c[:, 2] < (h + b) / h) & (c[:, 3] < (w + b) / w)


def dual_max_match(overlap, gt_valid, positive_threshold: float, ignore_threshold: float):
    """Dual-max matching (ref: nets/ssd_common.py:47-75), batched.

    overlap: [..., G, N] IoU (border-masked; padded gt rows all zero);
    gt_valid: [..., G] bool. Returns match_idx [..., N] int64 (gt index,
    -1 negative, -2 ignore) and match_scores [..., N], the IoU with the
    selected gt (the claiming gt where one claims the anchor).

    Argmax ties go to the lowest index on both axes, as `jnp.argmax` (and
    `torch.argmax`) resolve them; of two valid gts that claim one anchor
    the lower index wins, as the JAX one-hot argmax does (encode.py:86-91)."""
    g, n = overlap.shape[-2:]
    anchors_to_gt = overlap.argmax(dim=-2)
    match_values = overlap.amax(dim=-2)
    match_idx = torch.where(match_values < ignore_threshold, -1, anchors_to_gt)
    ignore = (match_values >= ignore_threshold) & (match_values < positive_threshold)
    match_idx = torch.where(ignore, -2, match_idx)

    # gt -> anchor override: each valid gt claims its best anchor; the lowest
    # claiming gt index per anchor by a min-scatter (G means unclaimed).
    gt_to_anchors = overlap.argmax(dim=-1)  # [..., G]
    gt_index = torch.arange(g, device=overlap.device).expand_as(gt_to_anchors)
    claimant = torch.where(gt_valid, gt_index, g)
    claiming_gt = torch.full((*overlap.shape[:-2], n), g, dtype=torch.int64, device=overlap.device)
    claiming_gt = claiming_gt.scatter_reduce(-1, gt_to_anchors, claimant, reduce="amin")
    claimed = claiming_gt < g

    match_idx = torch.where(claimed, claiming_gt, match_idx)
    score_gt = torch.where(claimed, claiming_gt, anchors_to_gt)
    match_scores = overlap.gather(-2, score_gt.unsqueeze(-2)).squeeze(-2)
    return match_idx, match_scores


def encode(gt_labels, gt_boxes, gt_valid, anchors_cyxhw, anchors_corner, inside_mask,
           positive_threshold: float, ignore_threshold: float,
           prior_scaling: Tuple[float, float, float, float]) -> EncodedTargets:
    """`_encode_flat` (encode.py:107-176) over a batch: gt_labels [B, G],
    gt_boxes [B, G, 4] corner boxes (padded rows zero), gt_valid [B, G] bool;
    anchors [N, 4] (cy, cx, h, w) and corners, inside_mask [N] bool."""
    overlap = iou_matrix(gt_boxes, anchors_corner)  # [B, G, N]
    overlap = overlap * inside_mask.to(overlap.dtype)
    overlap = overlap * gt_valid.to(overlap.dtype)[..., None]
    match_idx, match_scores = dual_max_match(overlap, gt_valid, positive_threshold, ignore_threshold)

    matched = match_idx > -1
    safe_idx = match_idx.clamp(min=0)
    feat_labels = gt_labels.to(torch.int32).gather(-1, safe_idx)
    labels = feat_labels * matched.to(torch.int32) - (match_idx < -1).to(torch.int32)

    g = gt_boxes.gather(-2, safe_idx[..., None].expand(*safe_idx.shape, 4))  # [B, N, 4] corners
    gcy = (g[..., 0] + g[..., 2]) / 2.0
    gcx = (g[..., 1] + g[..., 3]) / 2.0
    gh = g[..., 2] - g[..., 0]
    gw = g[..., 3] - g[..., 1]
    acy, acx, ah, aw = anchors_cyxhw.unbind(-1)
    s0, s1, s2, s3 = prior_scaling
    gh_safe = torch.where(matched, gh, ah)
    gw_safe = torch.where(matched, gw, aw)
    tcy = (gcy - acy) / ah / s1
    tcx = (gcx - acx) / aw / s0
    th = torch.log(gh_safe / ah) / s3
    tw = torch.log(gw_safe / aw) / s2
    locations = torch.stack([tcx, tcy, tw, th], dim=-1) * matched.to(gt_boxes.dtype)[..., None]
    return EncodedTargets(labels=labels, locations=locations, scores=match_scores)


class TargetEncoder:
    """Encoder bound to an anchor layout (encode.py:179-228). The anchor
    tables live on the CPU and are copied once to each device the gts come
    on. `__call__` encodes one image, `batched` a batch (no loop over the
    images)."""

    def __init__(
        self,
        layout: AnchorLayout,
        img_shape: Tuple[int, int],
        positive_threshold: float = 0.5,
        ignore_threshold: float = 0.3,
        prior_scaling: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
    ):
        self.layout = layout
        self.img_shape = tuple(img_shape)
        self.positive_threshold = float(positive_threshold)
        self.ignore_threshold = float(ignore_threshold)
        self.prior_scaling = tuple(float(s) for s in prior_scaling)
        self._tables = {}
        self._cpu = (
            torch.as_tensor(layout.cyxhw),
            torch.as_tensor(layout.corners),
            torch.as_tensor(anchor_inside_mask(layout, self.img_shape)),
        )

    def _on(self, device):
        if device not in self._tables:
            self._tables[device] = tuple(t.to(device) for t in self._cpu)
        return self._tables[device]

    def batched(self, gt_labels, gt_boxes, gt_valid) -> EncodedTargets:
        """[B, G], [B, G, 4], [B, G] -> targets [B, N]."""
        gt_boxes = torch.as_tensor(gt_boxes, dtype=torch.float32)
        gt_labels = torch.as_tensor(gt_labels, device=gt_boxes.device)
        gt_valid = torch.as_tensor(gt_valid, device=gt_boxes.device).bool()
        return encode(gt_labels, gt_boxes, gt_valid, *self._on(gt_boxes.device),
                      self.positive_threshold, self.ignore_threshold, self.prior_scaling)

    def __call__(self, gt_labels, gt_boxes, gt_valid) -> EncodedTargets:
        """One image: [G], [G, 4], [G] -> targets [N]."""
        out = self.batched(*(torch.as_tensor(t)[None] for t in (gt_labels, gt_boxes, gt_valid)))
        return EncodedTargets(*(t[0] for t in out))
