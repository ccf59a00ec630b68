"""Fixpoint greedy-NMS keep mask: the CUDA kernel and its plain version.

Port of `ron_tensorflow_tpu/kernels/nms_pallas.py`
(`pallas_nms_fixpoint_keep_mask`, `nms_sorted_pallas` with
method='fixpoint'). The kernel is `csrc/nms_fixpoint.cu`. Both versions use
the TPU kernel's division-free predicate `inter >= t * denom && denom > 0`
(`nms_pallas.py:179-181`), so they give the same mask bit for bit; it is
the port's only NMS predicate. (The JAX package's CPU path,
`ops/nms.py::overlap_matrix`, divides instead and can differ from both
exactly at the threshold.)
"""

from __future__ import annotations

import torch

from . import _build

MODES = ("min", "union")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown NMS mode: {mode!r}")


def suppression_matrix(boxes: torch.Tensor, nms_threshold: float, mode: str) -> torch.Tensor:
    """[R, K, 4] score-sorted boxes -> bool [R, K, K], True at [r, i, j]
    when candidate i < j suppresses j."""
    _check_mode(mode)
    y0, x0, y1, x1 = boxes.unbind(-1)
    vol = (y1 - y0) * (x1 - x0)
    ih = torch.clamp(
        torch.minimum(y1[:, :, None], y1[:, None, :]) - torch.maximum(y0[:, :, None], y0[:, None, :]),
        min=0.0,
    )
    iw = torch.clamp(
        torch.minimum(x1[:, :, None], x1[:, None, :]) - torch.maximum(x0[:, :, None], x0[:, None, :]),
        min=0.0,
    )
    inter = ih * iw
    if mode == "union":
        denom = (vol[:, :, None] + vol[:, None, :]) - inter
    else:
        denom = torch.minimum(vol[:, :, None], vol[:, None, :])
    t = torch.tensor(nms_threshold, dtype=boxes.dtype, device=boxes.device)
    hit = (inter >= t * denom) & (denom > 0.0)
    k = boxes.shape[1]
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    return hit & upper


def fixpoint_keep(valid: torch.Tensor, sup: torch.Tensor):
    """Greedy keep set from its suppression relation: iterate
    keep[j] = valid[j] & no kept i suppresses j (sup [R, K, K], True at
    [r, i, j] for i < j) from keep = valid until nothing changes. Level n of
    the greedy recurrence settles after n steps, so K steps always suffice.
    Returns (keep [R, K], the number of steps taken, the last unchanged one
    included)."""
    keep = valid
    for step in range(1, valid.shape[-1] + 1):
        new = valid & ~(keep[:, :, None] & sup).any(dim=1)
        if torch.equal(new, keep):
            return keep, step
        keep = new
    return keep, valid.shape[-1]


def compact_keep(keep, scores, boxes, keep_top_k: int):
    """Cap the keep mask at keep_top_k (cumsum) and scatter the kept rows,
    already in score order, into zero-padded [R, keep_top_k(, 4)]."""
    pos = torch.cumsum(keep, dim=-1) - 1
    keep = keep & (pos < keep_top_k)
    dst = torch.where(keep, pos, keep_top_k)  # column keep_top_k is dropped
    r = scores.shape[0]
    out_s = scores.new_zeros(r, keep_top_k + 1).scatter_(1, dst, scores)
    out_b = boxes.new_zeros(r, keep_top_k + 1, 4).scatter_(
        1, dst[..., None].expand(-1, -1, 4), boxes
    )
    return out_s[:, :keep_top_k], out_b[:, :keep_top_k]


def nms_fixpoint_keep_mask_plain(
    scores: torch.Tensor, boxes: torch.Tensor, nms_threshold: float = 0.5, mode: str = "min"
) -> torch.Tensor:
    """Uncapped greedy-NMS keep mask, plain PyTorch. scores [R, K]
    descending, boxes [R, K, 4] -> bool [R, K]. Iterates
    keep[j] = valid[j] & no kept i < j suppresses j from keep = valid until
    nothing changes, at most K times."""
    keep, _ = fixpoint_keep(scores > 0.0, suppression_matrix(boxes, nms_threshold, mode))
    return keep


def nms_fixpoint_keep_mask(
    scores: torch.Tensor, boxes: torch.Tensor, nms_threshold: float = 0.5, mode: str = "min"
) -> torch.Tensor:
    """Uncapped greedy-NMS keep mask: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. scores [R, K] float32 descending,
    boxes [R, K, 4] float32 contiguous, K <= 1024 -> bool [R, K]."""
    _check_mode(mode)
    if scores.device.type == "cpu":
        return nms_fixpoint_keep_mask_plain(scores, boxes, nms_threshold, mode)
    if scores.device.type != "cuda" or boxes.device != scores.device:
        raise ValueError(f"tensors on {scores.device} and {boxes.device}: need one CUDA device")
    if scores.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError(f"need float32, got {scores.dtype} and {boxes.dtype}")
    if scores.dim() != 2 or boxes.shape != (*scores.shape, 4):
        raise ValueError(f"need scores [R, K] and boxes [R, K, 4], got {scores.shape}, {boxes.shape}")
    if not (scores.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("scores and boxes must be contiguous")
    r, k = scores.shape
    if k > 1024:
        raise ValueError(f"K={k} > 1024 candidates per row")
    keep = torch.empty(r, k, dtype=torch.bool, device=scores.device)
    with torch.cuda.device(scores.device):
        err = _build.library().nms_fixpoint_keep_mask(
            scores.data_ptr(), boxes.data_ptr(), keep.data_ptr(), r, k,
            float(nms_threshold), int(mode == "union"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check("nms_fixpoint_keep_mask", err)
    nms_fixpoint_keep_mask.launches += 1
    return keep


nms_fixpoint_keep_mask.launches = 0


def nms_sorted_kernel(
    scores: torch.Tensor,
    boxes: torch.Tensor,
    nms_threshold: float = 0.5,
    keep_top_k: int = 200,
    mode: str = "min",
):
    """Batched greedy NMS over score-sorted rows through the keep-mask
    kernel, then the `keep_top_k` cap (cumsum) and the compaction of
    `nms_pallas.py:292-300`.

    scores [R, K], boxes [R, K, 4] -> (scores [R, keep_top_k],
    boxes [R, keep_top_k, 4]), zero-padded, in score order."""
    keep = nms_fixpoint_keep_mask(scores.contiguous(), boxes.contiguous(), nms_threshold, mode)
    return compact_keep(keep, scores, boxes, keep_top_k)
