"""RON's training step in plain PyTorch: target encoding, the three-term
loss, the gradients by autograd and the momentum update, in float32.

Written from the published training graph (Kong et al., CVPR 2017;
`ron_vgg_320.py` and `ssd_common.py` of the reference): anchors matched
jointly over every feature layer to the ground truth by the dual maximum
(each anchor its best gt, each valid gt its best anchor); the objectness
term over the positives and negatives sampled at 3:1, the classification
term over the positives and sampled negatives that the predicted
objectness lets through, the smooth-L1 (sigma 3) box term over the
positives let through; SGD with momentum 0.9 and weight decay 5e-4 on the
convolution kernels (the transposed convolution's and BatchNorm's scales
are not decayed), at the learning rate of the schedule's first step.

The negatives are sampled with two uniform draws per anchor, handed in
(`draws`, [2, B, N]), so that the same draws can be given to a program
that samples with them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import nets, postprocess


def anchor_tables(cfg: dict, device):
    """(anchors [N, 4] (cy, cx, h, w), corners [N, 4], inside [N] bool):
    an anchor takes part in matching when its corners lie within its
    layer's allowed border (`allowed_borders`, pixels) of the image."""
    a = postprocess.anchors(cfg)
    cy, cx, h, w = (a[:, i] for i in range(4))
    corners = np.stack([cy - h / 2.0, cx - w / 2.0, cy + h / 2.0, cx + w / 2.0], -1).astype(np.float32)
    borders = np.concatenate([np.full(fh * fw * nets.anchors_per_cell(cfg, i), b, np.float32)
                              for i, ((fh, fw), b) in enumerate(zip(cfg["feat_shapes"], cfg["allowed_borders"]))])
    img_h, img_w = cfg["img_shape"]
    inside = ((corners[:, 0] >= -borders / img_h) & (corners[:, 1] >= -borders / img_w)
              & (corners[:, 2] < (img_h + borders) / img_h) & (corners[:, 3] < (img_w + borders) / img_w))
    return tuple(torch.as_tensor(t, device=device) for t in (a, corners, inside))


def iou(gt, anchors):
    """[B, G, 4] x [N, 4] corner boxes -> [B, G, N] IoU, 0 where the union is
    empty. The union adds the anchor's area (h x w) to the gt's with one
    rounding, a fused multiply-add as the published encoder runs compiled:
    an IoU within a rounding of a match threshold decides an anchor's label,
    and in a head with few positives one such anchor moves its gradient by a
    tenth or more."""
    ih = torch.clamp(torch.minimum(gt[..., 2, None], anchors[:, 2]) - torch.maximum(gt[..., 0, None], anchors[:, 0]),
                     min=0.0)
    iw = torch.clamp(torch.minimum(gt[..., 3, None], anchors[:, 3]) - torch.maximum(gt[..., 1, None], anchors[:, 1]),
                     min=0.0)
    inter = ih * iw
    area_g = ((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1]))[..., None]
    area_a = (anchors[:, 2] - anchors[:, 0]).double() * (anchors[:, 3] - anchors[:, 1]).double()
    union = (area_g.double() + area_a).float() - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def encode(cfg: dict, gt_labels, gt_boxes, gt_valid):
    """-> (labels [B, N] (class, 0 negative, -1 ignored), offsets [B, N, 4]
    (cx, cy, w, h) over the prior scaling)."""
    match = cfg["match"]
    anchors, corners, inside = anchor_tables(cfg, gt_boxes.device)
    overlap = iou(gt_boxes.float(), corners) * inside * gt_valid[..., None]
    b, g, n = overlap.shape
    best, best_gt = overlap.max(dim=1)  # each anchor's best gt (the first of equals)
    idx = torch.where(best < match["ignore_threshold"], -1, best_gt)
    idx = torch.where((best >= match["ignore_threshold"]) & (best < match["positive_threshold"]), -2, idx)
    # each valid gt claims its best anchor, whatever the thresholds; the lowest such gt wins an anchor
    claim = torch.full((b, n), g, dtype=torch.long, device=overlap.device)
    gt_index = torch.where(gt_valid, torch.arange(g, device=overlap.device), g)
    claim = claim.scatter_reduce(1, overlap.argmax(dim=2), gt_index, reduce="amin")
    idx = torch.where(claim < g, claim, idx)
    matched = idx >= 0
    safe = idx.clamp(min=0)
    labels = torch.where(matched, gt_labels.long().gather(1, safe), torch.where(idx == -2, -1, 0))
    box = gt_boxes.float().gather(1, safe[..., None].expand(b, n, 4))
    acy, acx, ah, aw = anchors.unbind(-1)
    s = [float(v) for v in cfg["prior_scaling"]]
    gh = torch.where(matched, box[..., 2] - box[..., 0], ah)
    gw = torch.where(matched, box[..., 3] - box[..., 1], aw)
    offsets = torch.stack([((box[..., 1] + box[..., 3]) / 2.0 - acx) / aw / s[0],
                           ((box[..., 0] + box[..., 2]) / 2.0 - acy) / ah / s[1],
                           torch.log(gw / aw) / s[2], torch.log(gh / ah) / s[3]], -1)
    return labels, offsets * matched[..., None]


def smooth_l1(x, sigma: float):
    return torch.where(x.abs() < 1.0 / sigma ** 2, 0.5 * (sigma * x) ** 2, x.abs() - 0.5 / sigma ** 2)


def loss(cfg: dict, out: Dict[str, torch.Tensor], labels, offsets, draws) -> torch.Tensor:
    """The RON loss of one batch: objectness, classification and box terms,
    each a mean over its selected anchors, weighted alpha, 1 - alpha - beta
    and beta; a term is 0 without positives."""
    lc = cfg["loss"]
    ratio, alpha, beta = lc["negative_ratio"], lc["alpha"], lc["beta"]
    pos, neg = labels > 0, labels == 0
    fired = out["objness_pred"].detach() > lc["objectness_threshold"]
    cls_pos, cls_neg = pos & fired, neg & fired

    def sampled(wanted, candidates, u):
        n_pos, n_cand = wanted.sum(), candidates.sum()
        keep = torch.minimum(torch.floor(ratio * n_pos.float()), n_cand.float())
        return candidates & (u < keep / n_cand.clamp(min=1))

    obj_sel = sampled(pos, neg, draws[0]) | pos
    cls_sel = sampled(cls_pos, cls_neg, draws[1]) | cls_pos

    def mean(values, mask):
        return (values * mask).sum() / mask.sum().clamp(min=1)

    obj_ce = torch.logsumexp(out["objness_logits"], -1) - out["objness_logits"][..., 1] * pos - \
        out["objness_logits"][..., 0] * ~pos
    cls_ce = torch.logsumexp(out["logits"], -1) - out["logits"].gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    box = smooth_l1(out["locations"] - offsets, lc["sigma"]).sum(-1)
    zero = torch.zeros((), device=labels.device)
    any_pos = pos.any()
    return (torch.where(any_pos, alpha * mean(obj_ce, obj_sel), zero)
            + torch.where(any_pos, (1.0 - alpha - beta) * mean(cls_ce, cls_sel), zero)
            + torch.where(cls_pos.any(), beta * mean(box, cls_pos), zero))


def decayed(cfg: dict) -> Dict[str, bool]:
    """{parameter: weight-decayed?}: the convolution kernels only."""
    return {k: kind == "kernel" for k, (_, kind) in nets.param_spec(cfg).items()}


def parameters(cfg: dict) -> List[str]:
    """The trained tensors (BatchNorm's running statistics are not)."""
    return [k for k, (_, kind) in nets.param_spec(cfg).items() if kind not in ("bn_mean", "bn_var")]


def trajectory(cfg: dict, weights: Dict[str, torch.Tensor], batches, draws, quant: Optional[Callable] = None):
    """The first len(batches) steps from `weights`, each batch a dict of the
    step's whitened images and gts -> (each step's loss, the first step's
    gradient by parameter, each parameter's change over all the steps)."""
    opt = cfg["optimizer"]
    names, decay = parameters(cfg), decayed(cfg)
    params = {k: v.detach().float().clone() for k, v in weights.items()}
    start = {k: params[k].clone() for k in names}
    trace = {k: torch.zeros_like(params[k]) for k in names}
    losses, first = [], None
    for batch, u in zip(batches, draws):
        leaves = {k: params[k].requires_grad_() for k in names}
        labels, offsets = encode(cfg, batch["gt_labels"], batch["gt_boxes"], batch["gt_valid"])
        out = nets.heads(cfg, params, batch["image"].float(), quant=quant, train=True)
        total = loss(cfg, out, labels, offsets, u)
        grads = torch.autograd.grad(total, [leaves[k] for k in names])
        losses.append(float(total.detach()))
        del out, total
        with torch.no_grad():
            if first is None:
                first = dict(zip(names, grads))
            for k, g in zip(names, grads):
                trace[k] = g + opt["weight_decay"] * params[k] * decay[k] + opt["momentum"] * trace[k]
                params[k] = params[k].detach() - opt["learning_rate"] * trace[k]
    return losses, first, {k: params[k] - start[k] for k in names}
