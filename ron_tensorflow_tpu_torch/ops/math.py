"""Small math utilities: the losses' elementwise terms, exact top-k with
`lax.top_k`'s tie order, subnormal flushing and the cumulative maximum.

Port of `ron_tensorflow_tpu/ops/math.py`. In `exact_top_k_chunked` ties go
to the smallest index, as `lax.top_k` does (`math.py:60-67`). `torch.topk`
does not promise that order (on the CPU it returns tied indices out of
order), so the selection is built on a stable descending sort.
"""

from __future__ import annotations

import torch


def _stable_top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def exact_top_k_chunked(x: torch.Tensor, k: int, num_chunks: int = 16):
    """Exact top-k along the last axis via per-chunk top-k + a final top-k
    over the candidate pool: the same values, indices, order and tie
    resolution as `lax.top_k`. Every global top-k element is inside its
    own chunk's top-k, and the pool is laid out chunk-major (ascending
    original index among equal scores), so the final stable selection
    picks the same elements in the same order. Falls back to one stable
    sort when chunking cannot shrink the problem (n < num_chunks * k)."""
    *lead, n = x.shape
    if num_chunks <= 1 or n < num_chunks * k:
        return _stable_top_k(x, k)
    pad = (-n) % num_chunks
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=float("-inf"))
    m = (n + pad) // num_chunks
    chunk_vals, chunk_idx = _stable_top_k(x.reshape(*lead, num_chunks, m), k)
    base = (torch.arange(num_chunks, device=x.device) * m)[:, None]
    pool_idx = (chunk_idx + base).reshape(*lead, num_chunks * k)
    pool_vals = chunk_vals.reshape(*lead, num_chunks * k)
    vals, pos = _stable_top_k(pool_vals, k)
    return vals, torch.gather(pool_idx, -1, pos)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """x with its subnormal values set to 0. The JAX package computes on the
    TPU, which has no subnormal floats, and on the CPU under XLA's
    flush-to-zero, as the reference's TensorFlow did: there a score below
    the smallest normal float is 0. torch keeps subnormals on the CPU and
    the card, so a head whose gate is `score > 0` flushes its scores first."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, torch.zeros((), dtype=x.dtype, device=x.device), x)


def safe_divide(numerator, denominator):
    """numerator / denominator where denominator > 0, else 0
    (ref: tf_extended/math.py:24-38)."""
    ok = denominator > 0
    quotient = numerator / torch.where(ok, denominator, torch.ones_like(denominator))
    return torch.where(ok, quotient, torch.zeros_like(quotient))


def smooth_l1(diff, sigma: float = 1.0):
    """Modified smooth-L1 of Fast R-CNN: 0.5 (sigma x)^2 where |x| < 1/sigma^2,
    else |x| - 0.5/sigma^2 (ref: nets/custom_layers.py:31-49; RON uses
    sigma = 3, ref: nets/ron_vgg_320.py:769)."""
    sigma2 = sigma * sigma
    absd = diff.abs()
    return torch.where(absd < 1.0 / sigma2, 0.5 * sigma2 * diff * diff, absd - 0.5 / sigma2)


def softmax_ce(logits, labels):
    """Sparse softmax cross-entropy in float32: logsumexp(logits) minus the
    logit of the label, picked by a one-hot product as `math.py:40-57` does
    (so the backward is the same elementwise product, no scatter)."""
    x = logits.float()
    one_hot = torch.nn.functional.one_hot(labels.long(), x.shape[-1]).to(x.dtype)
    return torch.logsumexp(x, dim=-1) - (x * one_hot).sum(-1)


def abs_smooth(x):
    """Smoothed L1 in the reference's differentiable min/abs form
    (ref: nets/custom_layers.py:51-63)."""
    absx = x.abs()
    return 0.5 * ((absx - 1.0) * torch.clamp(absx, max=1.0) + absx)


def cummax(x: torch.Tensor, reverse: bool = False, axis: int = 0) -> torch.Tensor:
    """Cumulative maximum along `axis`, from the end with `reverse`
    (`math.py:21-23`; ref: tf_extended/math.py:41-67)."""
    if reverse:
        return torch.cummax(x.flip(axis), dim=axis).values.flip(axis)
    return torch.cummax(x, dim=axis).values
