"""SSD training loss with hard negative mining.

Port of `ron_tensorflow_tpu/losses/ssd.py` (ref: nets/ssd_vgg_300.py:578-659):
positives are the anchors whose matched IoU score is above
`match_threshold`; negatives are mined hard (the lowest background
probability first) among the anchors that are neither positive nor ignored
(score > -0.5); every term is divided by the batch size.

The mining rule, kept bit for bit (`ssd.py:66-73`): n_neg = int(ratio *
n_pos) + B, truncated, then at most the number of candidate negatives; the
k-th value is the ascending-sorted candidates' [max(n_neg - 1, 0)], where
non-candidates sort last at 1.0; a candidate is taken when its background
probability is strictly below it. So n_neg = 0 takes nothing, the k-th
candidate itself is never taken, and ties with it are left out.

Over a mesh (`group` = the data group) the loss is the global batch's:
`batch_size`, `n_positives` and `max_neg_entries` are summed over the
group, and the threshold `kth` sorts the whole batch's candidates (their
`nvalues`, which carry no gradient, gathered in rank order). Each rank's
loss is its rows' share; the shares sum to the one-process loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..ops.math import abs_smooth, softmax_ce
from ..parallel.collectives import Group, all_gather_rows, all_reduce_sum, group_size


@dataclasses.dataclass(frozen=True)
class SsdLossConfig:
    num_classes: int = 21
    match_threshold: float = 0.5
    negative_ratio: float = 3.0
    alpha: float = 1.0  # localization weight


def ssd_losses(
    logits,
    locations,
    gclasses,
    glocations,
    gscores,
    config: SsdLossConfig = SsdLossConfig(),
    group: Group = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The SSD multibox loss.

    logits [B, N, C], locations [B, N, 4], gclasses [B, N] int labels,
    glocations [B, N, 4], gscores [B, N] the encoder's matched IoU.
    Returns (total, metrics): "loss/total", "loss/ce_pos", "loss/ce_neg",
    "loss/localization" and "counts/positives", 0-dim tensors."""
    cfg = config
    batch_size = logits.shape[0] * group_size(group)
    flat_logits = logits.reshape(-1, logits.shape[-1])
    flat_gclasses = gclasses.detach().reshape(-1)
    flat_gscores = gscores.detach().reshape(-1)
    flat_locs = locations.reshape(-1, 4)
    flat_glocs = glocations.detach().reshape(-1, 4)

    pmask = flat_gscores > cfg.match_threshold
    fpmask = pmask.float()

    # hard negative mining (ref: nets/ssd_vgg_300.py:616-636)
    background = torch.softmax(flat_logits.float(), dim=-1)[:, 0].detach()
    nmask = ~pmask & (flat_gscores > -0.5)
    fnmask = nmask.float()
    nvalues = torch.where(nmask, background, 1.0 - fnmask)
    n_positives, n_candidates = all_reduce_sum(torch.stack([fpmask.sum(), fnmask.sum()]), group).unbind()
    max_neg_entries = n_candidates.to(torch.int32)
    n_neg = (cfg.negative_ratio * n_positives).to(torch.int32) + batch_size
    n_neg = torch.minimum(n_neg, max_neg_entries)
    kth = torch.sort(all_gather_rows(nvalues, group)).values[torch.clamp(n_neg - 1, min=0)]
    fnmask = (nmask & (nvalues < kth)).float()

    ce_pos = softmax_ce(flat_logits, flat_gclasses.clamp(0, cfg.num_classes - 1))
    pos_loss = (ce_pos * fpmask).sum() / batch_size
    ce_neg = softmax_ce(flat_logits, pmask.to(torch.int64))
    neg_loss = (ce_neg * fnmask).sum() / batch_size
    loc_l1 = abs_smooth(flat_locs.float() - flat_glocs.float()).sum(-1)
    loc_loss = cfg.alpha * (loc_l1 * fpmask).sum() / batch_size

    total = pos_loss + neg_loss + loc_loss
    metrics = {
        "loss/total": total,
        "loss/ce_pos": pos_loss,
        "loss/ce_neg": neg_loss,
        "loss/localization": loc_loss,
        "counts/positives": n_positives,
    }
    return total, metrics
