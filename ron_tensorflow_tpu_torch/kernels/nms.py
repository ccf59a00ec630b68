"""Greedy-NMS keep masks: two CUDA launchers of one kernel, each beside its
plain version.

Port of `ron_tensorflow_tpu/kernels/nms_pallas.py`:

- fixpoint (`pallas_nms_fixpoint_keep_mask`): the uncapped keep mask, with
  the TPU kernel's division-free predicate `inter >= t * denom && denom > 0`
  (`nms_pallas.py:179-181`). The Detector's NMS. Its plain version iterates
  the suppression fixpoint, as the TPU kernel does.
- scan (`pallas_nms_keep_mask`): the keep mask with the `keep_top_k` cap
  inside, and the TPU scan kernel's dividing predicate
  `ov = inter / denom if denom > 0 else 0; ov >= t` (`nms_pallas.py:75`).
  Its plain version is the K-step sequential scan, as the TPU kernel's.

On the card both run `csrc/nms_greedy.cu`: one greedy sweep, templated on
the predicate and the cap, that takes the kept candidates one by one and
skips the untaken ones in bulk. Rows of K up to `MAX_K` candidates keep
their boxes in registers and shared memory. Wider rows (a Detector's
`top_k` at every anchor: 21250 for RON-320, 24564 for SSD-512) up to
`CLUSTER_MAX_K` go to a tile-batched sweep spread over a thread-block
cluster, each row's boxes in the shared memory of its cluster's CTAs (a
step resolves tiles of 32 candidates, one or more at once;
`cluster_layout` gives the cluster's size); the widest rows, up to 925,696
candidates, to a sweep over alive bits in shared memory with the boxes
read from global memory. Each launcher gives its plain version's mask bit
for bit at every K. The two predicates can disagree for a pair that sits
on the threshold, as the two TPU kernels do; each is held to its own TPU
kernel.
"""

from __future__ import annotations

import torch

from . import _build

MODES = ("min", "union")
# candidates per row up to which the CUDA sweep keeps a row's boxes on chip; wider rows take
# its wide-row path (`csrc/nms_greedy.cu`, kMaxK)
MAX_K = 4096
# widest row of the wide-row path's cluster kernel: 16 CTAs of 13,312 boxes each (208 KB of shared
# memory); wider rows take `nms_wide_kernel` (`csrc/nms_greedy.cu`, kClusterMaxK)
CLUSTER_MAX_K = 212_992
# pairs (rows x K x K) the fixpoint's plain version builds its overlaps for at once
PLAIN_PAIRS = 1 << 26


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown NMS mode: {mode!r}")


def _check_cuda_rows(scores: torch.Tensor, boxes: torch.Tensor):
    """Raise unless the rows are what the NMS kernel takes; returns
    (R, K, boxes), boxes copied to a 16-byte-aligned tensor if the view
    given is not (the kernel loads each box as one float4)."""
    if scores.device.type != "cuda" or boxes.device != scores.device:
        raise ValueError(f"tensors on {scores.device} and {boxes.device}: need one CUDA device")
    if scores.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError(f"need float32, got {scores.dtype} and {boxes.dtype}")
    if scores.dim() != 2 or boxes.shape != (*scores.shape, 4):
        raise ValueError(f"need scores [R, K] and boxes [R, K, 4], got {scores.shape}, {boxes.shape}")
    if not (scores.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("scores and boxes must be contiguous")
    r, k = scores.shape
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    return r, k, boxes


def cluster_layout(rows: int, k: int) -> tuple[int, int]:
    """(CTAs of each row's cluster, candidates of a tile) with which the
    current CUDA device's kernels sweep [rows, k] rows; 0 CTAs where K
    takes another kernel than the cluster one (K <= MAX_K or
    K > CLUSTER_MAX_K)."""
    lib = _build.library()
    ctas = lib.nms_cluster_ctas(rows, k)
    if ctas < 0:
        raise RuntimeError("nms_cluster_ctas: no CUDA device to ask")
    return ctas, lib.nms_tile_candidates()


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


def _compact(keep, keep_top_k: int, *rows):
    """Cap the keep mask [R, K] at keep_top_k (cumsum) and scatter each of
    the rows [R, K, ...] at the kept slots, already in score order, into a
    zero-filled [R, keep_top_k, ...]."""
    pos = torch.cumsum(keep, dim=-1) - 1
    keep = keep & (pos < keep_top_k)
    dst = torch.where(keep, pos, keep_top_k)  # column keep_top_k is dropped
    out = []
    for row in rows:
        idx = dst.reshape(*dst.shape, *([1] * (row.dim() - 2))).expand_as(row)
        full = row.new_zeros(row.shape[0], keep_top_k + 1, *row.shape[2:]).scatter_(1, idx, row)
        out.append(full[:, :keep_top_k])
    return out


def compact_keep(keep, scores, boxes, keep_top_k: int):
    """Cap the keep mask at keep_top_k (cumsum) and scatter the kept rows,
    already in score order, into zero-padded [R, keep_top_k(, 4)]."""
    return tuple(_compact(keep, keep_top_k, scores, boxes))


def compact_keep_labelled(keep, scores, labels, boxes, keep_top_k: int):
    """`compact_keep` for rows that carry labels: -> (scores, labels, boxes,
    valid) [R, keep_top_k(, 4)], zero-filled past the kept ones; valid is
    True exactly on the kept slots. The compaction of JAX `nms_with_labels`
    (`ops/nms.py:219-225`)."""
    return tuple(_compact(keep, keep_top_k, scores, labels, boxes, keep))


def nms_fixpoint_keep_mask_plain(
    scores: torch.Tensor, boxes: torch.Tensor, nms_threshold: float = 0.5, mode: str = "min"
) -> torch.Tensor:
    """Uncapped greedy-NMS keep mask, plain PyTorch. scores [R, K]
    descending, boxes [R, K, 4] -> bool [R, K]. Iterates
    keep[j] = valid[j] & no kept i < j suppresses j from keep = valid until
    nothing changes, at most K times. Rows go in groups of at most
    PLAIN_PAIRS pairs (one row at a time at K = 21250, whose [K, K]
    overlaps are 0.45 G elements), each group's [R, K, K] freed before the
    next."""
    k = scores.shape[-1]
    step = max(1, PLAIN_PAIRS // max(1, k * k))
    parts = [fixpoint_keep(scores[r:r + step] > 0.0, suppression_matrix(boxes[r:r + step], nms_threshold, mode))[0]
             for r in range(0, scores.shape[0], step)]
    return torch.cat(parts) if parts else scores > 0.0


def _steps_pointer(steps, r: int):
    """The data pointer of `steps` (None: 0), an int32 [R] tensor on the
    rows' device that the cluster kernel fills with each row's steps."""
    if steps is None:
        return 0
    if steps.dtype != torch.int32 or steps.shape != (r,) or not steps.is_contiguous():
        raise ValueError(f"steps must be a contiguous int32 [{r}] tensor, got {steps.dtype} {tuple(steps.shape)}")
    return steps.data_ptr()


def nms_fixpoint_keep_mask(
    scores: torch.Tensor, boxes: torch.Tensor, nms_threshold: float = 0.5, mode: str = "min", *,
    steps: torch.Tensor | None = None,
) -> torch.Tensor:
    """Uncapped greedy-NMS keep mask: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. scores [R, K] float32 descending,
    boxes [R, K, 4] float32 contiguous -> bool [R, K]. `steps`, an int32
    [R] tensor on the card, gets the cluster kernel's steps a row where it
    runs (MAX_K < K <= CLUSTER_MAX_K) and is left as it is elsewhere."""
    _check_mode(mode)
    if scores.device.type == "cpu":
        return nms_fixpoint_keep_mask_plain(scores, boxes, nms_threshold, mode)
    r, k, boxes = _check_cuda_rows(scores, boxes)
    keep = torch.empty(r, k, dtype=torch.bool, device=scores.device)
    with torch.cuda.device(scores.device):
        err = _build.library().nms_fixpoint_keep_mask(
            scores.data_ptr(), boxes.data_ptr(), keep.data_ptr(), _steps_pointer(steps, r), r, k,
            float(nms_threshold), int(mode == "union"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check("nms_fixpoint_keep_mask", err)
    nms_fixpoint_keep_mask.launches += 1
    return keep


nms_fixpoint_keep_mask.launches = 0


def nms_scan_keep_mask_plain(
    scores: torch.Tensor,
    boxes: torch.Tensor,
    nms_threshold: float = 0.5,
    keep_top_k: int = 200,
    mode: str = "min",
) -> torch.Tensor:
    """Capped greedy-NMS keep mask by the sequential scan, plain PyTorch: K
    steps, each vectorised over the rows. scores [R, K], boxes [R, K, 4]
    -> bool [R, K]. Step i takes candidate i iff it is alive, its score is
    > 0 and fewer than keep_top_k are kept; a taken i kills every j with
    ov(i, j) >= t, ov = inter / denom where denom > 0, else 0."""
    _check_mode(mode)
    y0, x0, y1, x1 = boxes.unbind(-1)
    vol = (y1 - y0) * (x1 - x0)
    t = torch.tensor(nms_threshold, dtype=boxes.dtype, device=boxes.device)
    r, k = scores.shape
    alive = torch.ones(r, k, dtype=torch.bool, device=scores.device)
    keep = torch.zeros(r, k, dtype=torch.bool, device=scores.device)
    kept = torch.zeros(r, dtype=torch.long, device=scores.device)
    for i in range(k):
        take = alive[:, i] & (scores[:, i] > 0.0) & (kept < keep_top_k)
        ih = torch.clamp(torch.minimum(y1, y1[:, i, None]) - torch.maximum(y0, y0[:, i, None]), min=0.0)
        iw = torch.clamp(torch.minimum(x1, x1[:, i, None]) - torch.maximum(x0, x0[:, i, None]), min=0.0)
        inter = ih * iw
        if mode == "union":
            denom = (vol + vol[:, i, None]) - inter
        else:
            denom = torch.minimum(vol, vol[:, i, None])
        pos = denom > 0.0
        ov = torch.where(pos, inter / torch.where(pos, denom, 1.0), 0.0)
        alive &= ~((ov >= t) & take[:, None])
        keep[:, i] = take
        kept += take
    return keep


def nms_scan_keep_mask(
    scores: torch.Tensor,
    boxes: torch.Tensor,
    nms_threshold: float = 0.5,
    keep_top_k: int = 200,
    mode: str = "min",
    *,
    steps: torch.Tensor | None = None,
) -> torch.Tensor:
    """Capped greedy-NMS keep mask by the sequential scan: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor. scores [R, K]
    float32, boxes [R, K, 4] float32 contiguous -> bool [R, K]. `steps` as
    `nms_fixpoint_keep_mask`'s."""
    _check_mode(mode)
    if scores.device.type == "cpu":
        return nms_scan_keep_mask_plain(scores, boxes, nms_threshold, keep_top_k, mode)
    r, k, boxes = _check_cuda_rows(scores, boxes)
    keep = torch.empty(r, k, dtype=torch.bool, device=scores.device)
    with torch.cuda.device(scores.device):
        err = _build.library().nms_scan_keep_mask(
            scores.data_ptr(), boxes.data_ptr(), keep.data_ptr(), _steps_pointer(steps, r), r, k,
            float(nms_threshold), int(min(keep_top_k, k)), int(mode == "union"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check("nms_scan_keep_mask", err)
    nms_scan_keep_mask.launches += 1
    return keep


nms_scan_keep_mask.launches = 0

METHODS = ("fixpoint", "scan")


def nms_sorted_kernel(
    scores: torch.Tensor,
    boxes: torch.Tensor,
    nms_threshold: float = 0.5,
    keep_top_k: int = 200,
    mode: str = "min",
    method: str = "fixpoint",
):
    """Batched greedy NMS over score-sorted rows through a keep-mask kernel,
    then the `keep_top_k` cap (cumsum) and the compaction of
    `nms_sorted_pallas` (`nms_pallas.py:260-300`). method 'fixpoint' (the
    Detector's) or 'scan' (the cap also inside the kernel).

    scores [R, K], boxes [R, K, 4] -> (scores [R, keep_top_k],
    boxes [R, keep_top_k, 4]), zero-padded, in score order."""
    if method not in METHODS:
        raise ValueError(f"unknown NMS method: {method!r}")
    s, b = scores.contiguous(), boxes.contiguous()
    if method == "fixpoint":
        keep = nms_fixpoint_keep_mask(s, b, nms_threshold, mode)
    else:
        keep = nms_scan_keep_mask(s, b, nms_threshold, keep_top_k, mode)
    return compact_keep(keep, scores, boxes, keep_top_k)
