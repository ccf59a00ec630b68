"""RON training loss: objectness + objectness-gated classification +
localization.

Port of `ron_tensorflow_tpu/losses/ron.py` (ref: nets/ron_vgg_320.py:635-779),
branch for branch:

- positives: anchors with encoded label > 0; ignore (-1) is excluded
  everywhere;
- objectness: softmax CE on is-positive over the positives and randomly
  sampled negatives at `negative_ratio`:1, weight `alpha`;
- classification: positives gated by predicted objectness >
  `objectness_threshold`; negatives the objectness-fired anchors of label 0,
  sampled 3:1 against the gated positives; weight `1 - alpha - beta`;
- localization: smooth-L1 (sigma 3) summed over the 4 coordinates, averaged
  over the gated positives, weight `beta`;
- masked means divide by max(count, 1), and a branch is 0 when it has no
  positives (`where(n_positives > 0, ...)`).

The two uniform draws [B, N] that sample the negatives come from an explicit
`torch.Generator`, or are handed in (`draws`), so that a test can give the
JAX loss's draws to both. All [B, N] inputs are reduced over both axes.

Over a mesh (`group` = the data group, `rows` = (offset, global batch)):
the loss is the global batch's, as GSPMD computes it in the JAX package.
Each rank's loss is its share, its rows' numerators over the global
denominators: the counts (`n_positives`, `n_negatives`, `n_cls_pos`,
`n_cls_neg`), hence `p_select` and `p_cls`, and the masked means'
denominators are summed over the group (two all-reduces of a few scalars).
The shares sum to the one-process loss; the train step sums their
gradients over the group. The draws are the global batch's, cut to the
rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops.math import smooth_l1, softmax_ce
from ..parallel.collectives import Group, all_reduce_sum


@dataclasses.dataclass(frozen=True)
class RonLossConfig:
    """Hyper-parameters (defaults = the published training flags,
    ref: ron_net.py:52-63)."""

    num_classes: int = 21
    negative_ratio: float = 3.0
    alpha: float = 1.0 / 3.0  # objectness weight
    beta: float = 1.0 / 5.0  # localization weight
    objectness_threshold: float = 0.03
    sigma: float = 3.0  # smooth-L1 transition


def _masked_mean(values, mask, denom):
    """sum(values * mask) / max(denom, 1), denom the mask's global count."""
    return (values * mask.to(values.dtype)).sum() / torch.clamp(denom, min=1.0)


def _global_counts(group: Group, *masks):
    """Each mask's count of True, summed over the group: one all-reduce."""
    return all_reduce_sum(torch.stack([m.float().sum() for m in masks]), group).unbind()


def _sample_probability(n_wanted_per_positive, n_positives, n_candidates):
    """P(a candidate negative is kept): min(int(ratio * n_pos), n_cand) /
    max(n_cand, 1), 0 without candidates (losses/ron.py:99-102)."""
    n_select = torch.minimum((n_wanted_per_positive * n_positives).to(torch.int32),
                             n_candidates.to(torch.int32)).float()
    return torch.where(n_candidates > 0, n_select / torch.clamp(n_candidates, min=1.0), 0.0)


def draw_uniforms(shape, generator: Optional[torch.Generator] = None, device=None):
    """The loss's two uniform draws, [2, *shape], on the generator's device."""
    device = generator.device if generator is not None else device
    return torch.rand((2, *shape), generator=generator, device=device)


def ron_losses(
    logits,
    locations,
    objness_logits,
    objness_pred,
    gclasses,
    glocations,
    config: RonLossConfig = RonLossConfig(),
    generator: Optional[torch.Generator] = None,
    draws=None,
    group: Group = None,
    rows=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The three-term RON loss.

    logits [B, N, C], locations [B, N, 4], objness_logits [B, N, 2],
    objness_pred [B, N] (post-softmax P(object)), gclasses [B, N] int
    (0 negative, -1 ignore), glocations [B, N, 4]. The negatives are sampled
    with `draws` ([2, B, N] uniforms: objectness, then classification) or,
    without them, with two draws from `generator`. With `rows` = (offset,
    global batch), `draws` (or the generator's draws) are the global
    batch's, [2, global batch, N], and this rank's rows are taken; `group`
    sums the counts over the data group (see the module's docstring).

    Returns (total loss, metrics): the three weighted components under
    "loss/...", the positive counts under "counts/...", all 0-dim tensors."""
    cfg = config
    if draws is None:
        shape = gclasses.shape if rows is None else (rows[1], *gclasses.shape[1:])
        draws = draw_uniforms(shape, generator, gclasses.device)
    rand_obj, rand_cls = (torch.as_tensor(d, device=gclasses.device) for d in draws)
    if rows is not None:
        rand_obj, rand_cls = (r.narrow(0, rows[0], gclasses.shape[0]) for r in (rand_obj, rand_cls))
    gclasses, glocations = gclasses.detach(), glocations.detach()

    positive_mask = gclasses > 0
    negative_mask = gclasses == 0
    objectness_mask = objness_pred.detach() > cfg.objectness_threshold
    cls_positive_mask = positive_mask & objectness_mask
    cls_negative_mask = objectness_mask & negative_mask
    n_positives, n_negatives, n_cls_pos, n_cls_neg = _global_counts(
        group, positive_mask, negative_mask, cls_positive_mask, cls_negative_mask)

    # objectness branch: random negative:positive sampling (ref: :700-717)
    p_select = _sample_probability(cfg.negative_ratio, n_positives, n_negatives)
    obj_mask = (negative_mask & (rand_obj < p_select)) | positive_mask
    # classification branch, gated by the predicted objectness (ref: :721-754)
    p_cls = _sample_probability(cfg.negative_ratio, n_cls_pos, n_cls_neg)
    cls_mask = (cls_negative_mask & (rand_cls < p_cls)) | cls_positive_mask
    n_obj, n_cls = _global_counts(group, obj_mask, cls_mask)

    obj_ce = softmax_ce(objness_logits, positive_mask.to(torch.int64))
    zero = torch.zeros((), device=gclasses.device)
    objness_loss = torch.where(n_positives > 0, cfg.alpha * _masked_mean(obj_ce, obj_mask, n_obj), zero)
    cls_ce = softmax_ce(logits, gclasses.clamp(0, cfg.num_classes - 1))
    cls_weight = 1.0 - cfg.alpha - cfg.beta
    cls_loss = torch.where(n_positives > 0, cls_weight * _masked_mean(cls_ce, cls_mask, n_cls), zero)

    # localization branch (ref: :766-778)
    loc_l1 = smooth_l1(locations.float() - glocations.float(), cfg.sigma).sum(-1)
    loc_loss = torch.where(n_cls_pos > 0, cfg.beta * _masked_mean(loc_l1, cls_positive_mask, n_cls_pos), zero)

    total = objness_loss + cls_loss + loc_loss
    metrics = {
        "loss/total": total,
        "loss/objectness": objness_loss,
        "loss/classification": cls_loss,
        "loss/localization": loc_loss,
        "counts/positives": n_positives,
        "counts/cls_positives": n_cls_pos,
    }
    return total, metrics
