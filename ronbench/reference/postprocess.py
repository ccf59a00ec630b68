"""The detection heads' postprocess in plain PyTorch: anchors, box decoding,
gates, exact top-k and greedy non-maximum suppression.

Two heads, as the published evaluation scripts define them:

- `detect` (eval_ron_network.py, `detected_bboxes`): the objectness gate and
  the min-size filter, per-class scores above the select threshold, each
  class's top-k (ties to the lower anchor), greedy NMS in 'min' mode, the
  first keep_top_k kept.
- `realtime` (ron_eval.py): score = objectness x class probability, the
  argmax class, the objectness, select, min-size and centre gates, the
  top-k of the valid anchors, class-blind greedy NMS in 'union' mode
  capped at keep_top_k.

The overlap test is the one the configuration names: 'divide'
(inter / denom >= t) or 'multiply' (inter >= t * denom), denom > 0 in
both. `dtype` is the precision the postprocess computes in.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def anchors(cfg: dict) -> np.ndarray:
    """[N, 4] (cy, cx, h, w) float32 over every feature layer, layers in
    configuration order, each row-major in (y, x, anchor); the centre and
    size are re-derived from float32 corners, as the published encoder does
    (ssd_common.py)."""
    img_h, img_w = cfg["img_shape"]
    out = []
    for (fh, fw), sizes, ratios, step in zip(cfg["feat_shapes"], cfg["anchor_sizes"], cfg["anchor_ratios"],
                                             cfg["anchor_steps"]):
        y, x = np.mgrid[0:fh, 0:fw]
        y = ((y.astype(np.float32) + cfg["anchor_offset"]) * step) / img_h
        x = ((x.astype(np.float32) + cfg["anchor_offset"]) * step) / img_w
        if cfg["anchor_style"] == "ron":  # anchor i * len(sizes) + j: ratio i, size j
            hs = [s / img_h / math.sqrt(r) for r in ratios for s in sizes]
            ws = [s / img_w * math.sqrt(r) for r in ratios for s in sizes]
        else:  # sizes[0], sqrt(sizes[0] * sizes[1]), then sizes[0] at each ratio
            hs = [sizes[0] / img_h, math.sqrt(sizes[0] * sizes[1]) / img_h] + [sizes[0] / img_h / math.sqrt(r)
                                                                               for r in ratios]
            ws = [sizes[0] / img_w, math.sqrt(sizes[0] * sizes[1]) / img_w] + [sizes[0] / img_w * math.sqrt(r)
                                                                               for r in ratios]
        h, w = np.asarray(hs, np.float32), np.asarray(ws, np.float32)
        y, x = y[..., None], x[..., None]
        ymin, xmin = (y - h / 2.0).astype(np.float32), (x - w / 2.0).astype(np.float32)
        ymax, xmax = (y + h / 2.0).astype(np.float32), (x + w / 2.0).astype(np.float32)
        shape = (fh, fw, len(hs))
        out.append(np.stack([np.broadcast_to((ymin + ymax) / 2.0, shape), np.broadcast_to((xmin + xmax) / 2.0, shape),
                             np.broadcast_to(ymax - ymin, shape), np.broadcast_to(xmax - xmin, shape)],
                            -1).reshape(-1, 4).astype(np.float32))
    return np.concatenate(out)


def decode(locations, anchors_cyxhw, scaling):
    """Offsets (cx, cy, w, h) on anchors (cy, cx, h, w) -> corner boxes
    (ymin, xmin, ymax, xmax) clipped to the unit square, an empty box where
    the clip leaves nothing."""
    acy, acx, ah, aw = anchors_cyxhw.unbind(-1)
    cx = locations[..., 0] * aw * scaling[0] + acx
    cy = locations[..., 1] * ah * scaling[1] + acy
    w = aw * torch.exp(locations[..., 2] * scaling[2])
    h = ah * torch.exp(locations[..., 3] * scaling[3])
    ymin, xmin = torch.clamp(cy - h / 2.0, min=0.0), torch.clamp(cx - w / 2.0, min=0.0)
    ymax, xmax = torch.clamp(cy + h / 2.0, max=1.0), torch.clamp(cx + w / 2.0, max=1.0)
    return torch.stack([torch.minimum(ymin, ymax), torch.minimum(xmin, xmax), ymax, xmax], -1)


def big_enough(boxes, min_size):
    return ((boxes[..., 3] - boxes[..., 1]) > min_size) & ((boxes[..., 2] - boxes[..., 0]) > min_size)


def top_k(scores, k: int):
    """The k largest along the last axis, descending, ties to the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def greedy_keep(valid, boxes, threshold: float, mode: str, test: str, cap: int = 0):
    """Greedy NMS keep mask over score-sorted rows [R, K]: candidate i is
    kept when it is valid, no kept box before it suppresses it and (with a
    cap) fewer than `cap` are kept; a kept box suppresses each later one
    whose overlap passes the test."""
    y0, x0, y1, x1 = boxes.unbind(-1)
    vol = (y1 - y0) * (x1 - x0)
    r, k = valid.shape
    alive, keep = valid.clone(), torch.zeros_like(valid)
    kept = torch.zeros(r, dtype=torch.long, device=valid.device)
    later = torch.arange(k, device=valid.device)
    for i in range(k):
        take = alive[:, i] & ((kept < cap) if cap else True)
        keep[:, i] = take
        kept += take.long()
        inter = (torch.clamp(torch.minimum(y1, y1[:, i, None]) - torch.maximum(y0, y0[:, i, None]), min=0.0)
                 * torch.clamp(torch.minimum(x1, x1[:, i, None]) - torch.maximum(x0, x0[:, i, None]), min=0.0))
        if mode == "union":
            denom = (vol + vol[:, i, None]) - inter
        else:
            denom = torch.minimum(vol, vol[:, i, None])
        pos = denom > 0.0
        if test == "divide":
            hit = torch.where(pos, inter / torch.where(pos, denom, torch.ones_like(denom)), 0.0) >= threshold
        else:
            hit = (inter >= threshold * denom) & pos
        alive &= ~(take[:, None] & hit & (later > i))
    return keep


def compact(keep, n: int, *rows):
    """The first n kept entries of each row, in order, zero-filled."""
    r = keep.shape[0]
    pos = torch.cumsum(keep.long(), -1) - 1
    slot = torch.where(keep & (pos < n), pos, torch.full_like(pos, n))
    out = []
    for t in rows:
        dst = torch.zeros((r, n + 1, *t.shape[2:]), dtype=t.dtype, device=t.device)
        idx = slot.reshape(r, -1, *([1] * (t.dim() - 2))).expand_as(t)
        out.append(dst.scatter(1, idx, t)[:, :n])
    return out


def detect(heads: Dict[str, torch.Tensor], cfg: dict, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The streaming detection head -> scores [B, C-1, keep_top_k], boxes
    [B, C-1, keep_top_k, 4], and the NMS rows (scores, boxes, keep mask)."""
    d = cfg["detection"]
    a = torch.as_tensor(anchors(cfg), device=heads["locations"].device).to(dtype)
    boxes = decode(heads["locations"].to(dtype), a, [float(s) for s in cfg["prior_scaling"]])
    p = heads["predictions"].to(dtype)
    gate = (heads["objness_pred"].to(dtype) > d["objectness_threshold"]) & big_enough(boxes, d["min_size"])
    fg = p[..., 1:].transpose(1, 2)  # [B, C-1, N]
    scores = torch.where(gate[:, None] & (fg > d["select_threshold"]), fg, torch.zeros((), dtype=dtype,
                                                                                      device=fg.device))
    b, c, n = scores.shape
    k = min(d["top_k"], n)
    s, idx = top_k(scores, k)
    bx = torch.gather(boxes[:, None].expand(b, c, n, 4), 2, idx[..., None].expand(b, c, k, 4))
    s, bx = s.reshape(b * c, k), bx.reshape(b * c, k, 4)
    keep = greedy_keep(s > 0, bx, d["nms_threshold"], d["nms_mode"], cfg["nms_test"]["detection"])
    out_s, out_b = compact(keep, d["keep_top_k"], s, bx)
    return {"scores": out_s.reshape(b, c, -1), "boxes": out_b.reshape(b, c, -1, 4),
            "rows": (s, bx, keep)}


def realtime(heads: Dict[str, torch.Tensor], cfg: dict, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The realtime head (whole-image mode) -> scores, labels, boxes, valid
    [B, keep_top_k(, 4)], and the NMS rows (valid as 1/0, boxes, keep mask)."""
    d = cfg["realtime"]
    a = torch.as_tensor(anchors(cfg), device=heads["locations"].device).to(dtype)
    boxes = decode(heads["locations"].to(dtype), a, [float(s) for s in cfg["prior_scaling"]])
    obj = heads["objness_pred"].to(dtype)
    sc = obj[..., None] * heads["predictions"].to(dtype)
    sc = torch.where(sc.abs() < torch.finfo(dtype).tiny, torch.zeros((), dtype=dtype, device=sc.device), sc)
    best, labels = torch.max(sc, -1)  # the first of equal maxima
    cy, cx = (boxes[..., 0] + boxes[..., 2]) / 2.0, (boxes[..., 1] + boxes[..., 3]) / 2.0
    valid = ((labels > 0) & (obj > d["objectness_threshold"]) & (best > d["select_threshold"])
             & big_enough(boxes, max(d["min_size"], 1e-4)) & (cy > 0.0) & (cy < 1.0) & (cx > 0.0) & (cx < 1.0))
    k = min(d["top_k"], best.shape[-1])
    s, idx = top_k(torch.where(valid, best, torch.zeros((), dtype=dtype, device=best.device)), k)
    lab, v = torch.gather(labels, 1, idx), torch.gather(valid, 1, idx)
    bx = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    keep = greedy_keep(v, bx, d["nms_threshold"], d["nms_mode"], cfg["nms_test"]["realtime"], d["keep_top_k"])
    out_s, out_l, out_b, out_v = compact(keep, d["keep_top_k"], s, lab, bx, keep)
    return {"scores": out_s, "labels": out_l, "boxes": out_b, "valid": out_v, "rows": (v.to(dtype), bx, keep)}


HEADS = {"detect": detect, "realtime": realtime}
