"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a CUDA device every test here skips. This file
imports torch and the port only, so it runs on a GPU host without JAX:
`python -m pytest tests/test_torch_cuda.py -m cuda`.
"""

import functools
import json

import pytest
import torch

from ron_tensorflow_tpu_torch import kernels
from ron_tensorflow_tpu_torch.kernels import (
    fused_conv3x3_relu_pool2,
    fused_conv3x3_relu_pool2_plain,
    fused_stem_conv_relu_pool2,
    fused_stem_conv_relu_pool2_plain,
    fused_vgg_block1,
    fused_vgg_block1_plain,
    nms_fixpoint_keep_mask,
    nms_fixpoint_keep_mask_plain,
    nms_scan_keep_mask,
    nms_scan_keep_mask_plain,
)
from ron_tensorflow_tpu_torch.kernels.fused_conv_pool import block1_reference
from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, Detector, RealtimeConfig, RealtimeDetector
from ron_tensorflow_tpu_torch.kernels import _build
from ron_tensorflow_tpu_torch.kernels.nms import CLUSTER_MAX_K, MAX_K, cluster_layout
from ron_tensorflow_tpu_torch.models import get_network
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC
from ron_tensorflow_tpu_torch.ops.matching import match_all_classes
from ron_tensorflow_tpu_torch.models.layers import init_like_flax_
from ron_tensorflow_tpu_torch.models.testing import seeded_flax_params
from ron_tensorflow_tpu_torch.ops.encode import TargetEncoder
from ron_tensorflow_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from ron_tensorflow_tpu_torch.train.state import create_train_state, make_train_step
from ron_tensorflow_tpu_torch.weights import from_jax_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def sorted_rows(seed, r, k, grid=None):
    g = torch.Generator().manual_seed(seed)
    cy, cx = torch.rand(2, r, k, generator=g) * 0.6 + 0.2
    h, w = torch.rand(2, r, k, generator=g) * 0.35 + 0.05
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    if grid:
        boxes = torch.round(boxes * grid) / grid
    scores = torch.where(torch.rand(r, k, generator=g) < 0.2, 0.0, torch.rand(r, k, generator=g))
    scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return scores.contiguous(), torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("r,k,grid,thr", [(640, 200, None, 0.4), (33, 1024, 8, 0.5), (5, 31, 4, 0.25),
                                          (8, 2048, 4, 0.25), (4, 4096, 4, 0.25)])
def test_nms_kernel_equals_plain(cuda, r, k, grid, thr, mode):
    scores, boxes = (t.to(cuda) for t in sorted_rows(r + k, r, k, grid))
    kernels.reset_launch_counts()
    got = nms_fixpoint_keep_mask(scores, boxes, thr, mode)
    torch.cuda.synchronize()
    assert nms_fixpoint_keep_mask.launches == 1
    ref = nms_fixpoint_keep_mask_plain(scores, boxes, thr, mode)
    assert torch.equal(got, ref)


NMS_SHAPES = [(640, 200, None, 0.4), (33, 1024, 8, 0.5), (5, 31, 4, 0.25), (8, 2048, 4, 0.25), (4, 4096, 4, 0.25)]


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("r,k,grid,thr", NMS_SHAPES)
@pytest.mark.parametrize("keep_top_k", [16, 100, 200])
def test_nms_scan_kernel_equals_plain(cuda, r, k, grid, thr, mode, keep_top_k):
    scores, boxes = (t.to(cuda) for t in sorted_rows(r + k + keep_top_k, r, k, grid))
    kernels.reset_launch_counts()
    got = nms_scan_keep_mask(scores, boxes, thr, keep_top_k, mode)
    torch.cuda.synchronize()
    assert nms_scan_keep_mask.launches == 1
    ref = nms_scan_keep_mask_plain(scores, boxes, thr, keep_top_k, mode)
    assert torch.equal(got, ref)
    assert int(got.sum(-1).max()) <= keep_top_k


def edge_rows(edge, r, k):
    """NMS rows at the sweep's edges: 'nan first' (random rows whose first
    score is NaN, as a descending sort puts it: the valid candidates are no
    prefix), 'disjoint' (boxes in disjoint grid cells: all K kept, the
    longest chain of steps), 'identical' (one box K times: one kept) and
    'borderline' (box 0 against boxes shifted by float32 ulps so that their
    overlap with it lies within a few ulps of 0.4, the threshold these rows
    are run at, in 'min' mode for the even ones and in 'union' mode for the
    odd ones: the pairs that K-C's kernel decides by dividing)."""
    scores = torch.linspace(1.0, 0.01, k).repeat(r, 1)
    if edge == "nan first":
        scores, boxes = sorted_rows(k + 7, r, k)
        scores[:, 0] = float("nan")
    elif edge == "disjoint":
        side = int(k ** 0.5 + 0.999999)
        cell = torch.arange(k)
        y0, x0 = (cell // side) / side, (cell % side) / side
        boxes = torch.stack([y0, x0, y0 + 0.5 / side, x0 + 0.5 / side], -1).repeat(r, 1, 1)
    elif edge == "borderline":
        j = torch.arange(k)
        x = torch.where(j % 2 == 0, 0.6, 3 / 7) + (j // 2 - k // 4) * 2.0 ** -24
        x[0] = 0.0
        boxes = torch.stack([torch.full((k,), 0.2), x, torch.full((k,), 0.7), x + 1], -1).repeat(r, 1, 1)
    else:
        boxes = torch.tensor([0.2, 0.3, 0.6, 0.5]).repeat(r, k, 1)
    return scores.contiguous(), boxes.contiguous()


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("k", [200, MAX_K, 8732, 21250])
@pytest.mark.parametrize("edge", ["nan first", "disjoint", "identical", "borderline"])
def test_nms_edge_rows_equal_plain(cuda, edge, k, mode):
    """Both kernels against their plain versions on the edge rows, K-C also
    with keep_top_k 0 (nothing kept) and K (no binding cap)."""
    scores, boxes = (t.to(cuda) for t in edge_rows(edge, 2, k))
    caps = (0, 100, k)
    kernels.reset_launch_counts()
    fix = nms_fixpoint_keep_mask(scores, boxes, 0.4, mode)
    scan = [nms_scan_keep_mask(scores, boxes, 0.4, cap, mode) for cap in caps]
    torch.cuda.synchronize()
    assert nms_fixpoint_keep_mask.launches == 1 and nms_scan_keep_mask.launches == len(caps)
    assert torch.equal(fix, nms_fixpoint_keep_mask_plain(scores, boxes, 0.4, mode))
    for cap, got in zip(caps, scan):
        assert torch.equal(got, nms_scan_keep_mask_plain(scores, boxes, 0.4, cap, mode)), cap
    assert not scan[0].any()
    kept = {"disjoint": k, "identical": 1}.get(edge)
    if kept is not None:
        assert fix.sum(-1).tolist() == [kept] * 2 and scan[2].sum(-1).tolist() == [kept] * 2
    first_kept = edge != "nan first"
    assert bool(fix[:, 0].all()) == first_kept and bool(scan[2][:, 0].all()) == first_kept


def first_kept(keep, cap):
    """The first `cap` kept of each row: K-C's mask at keep_top_k cap, from
    its mask at keep_top_k K (a taken candidate's kills do not depend on
    the cap; tests/test_torch_nms_tiles.py checks this on the plain
    version)."""
    return keep & (torch.cumsum(keep, -1) <= cap)


def tiles_holding_a_kept_box(keep, tile):
    return torch.tensor([len(torch.unique(row.nonzero().squeeze(1) // tile)) for row in keep.cpu()])


WIDE_K = [MAX_K + 1, 8732, 21250, 24564]  # past MAX_K; SSD-300's, RON-320's and SSD-512's anchors
WIDE_CAPS = (1, 7, 20, 33, 200)  # K-C's caps: mid-tile (7, 20), past a tile's end; K too


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("k", WIDE_K)
def test_nms_kernels_on_wide_rows_equal_plain(cuda, k, mode):
    """Rows of more than MAX_K candidates (a Detector's top_k at every
    anchor) through the wide-row cluster kernel on [1, K], [2, K] and
    [40, K] rows (each its own cluster size): K-A, and K-C capped at 1, 7,
    20, 33, 200 and K, bit-equal to the plain versions on the same rows;
    each row's steps take at least one and at most C of its tiles that
    hold a kept box. K-C's plain version runs at keep_top_k K, and on the
    two rows also at 20 and 200."""
    scores, boxes = (t.to(cuda) for t in sorted_rows(k + 3, 40, k))
    fix_ref = nms_fixpoint_keep_mask_plain(scores, boxes, 0.4, mode)
    scan_ref = nms_scan_keep_mask_plain(scores, boxes, 0.4, k, mode)
    sizes = set()
    for r in (1, 2, 40):
        s, b = scores[:r].contiguous(), boxes[:r].contiguous()
        ctas, tile = cluster_layout(r, k)
        sizes.add(ctas)
        steps = torch.zeros(r, dtype=torch.int32, device=cuda)
        kernels.reset_launch_counts()
        fix = nms_fixpoint_keep_mask(s, b, 0.4, mode, steps=steps)
        scan = [nms_scan_keep_mask(s, b, 0.4, cap, mode) for cap in WIDE_CAPS + (k,)]
        torch.cuda.synchronize()
        assert nms_fixpoint_keep_mask.launches == 1 and nms_scan_keep_mask.launches == len(WIDE_CAPS) + 1
        assert torch.equal(fix, fix_ref[:r]), r
        for cap, got in zip(WIDE_CAPS + (k,), scan):
            assert torch.equal(got, first_kept(scan_ref[:r], cap)), (r, cap)
            if r == 2 and cap in (20, 200):  # and against the plain version run at that cap
                assert torch.equal(got, nms_scan_keep_mask_plain(s, b, 0.4, cap, mode)), cap
        held = tiles_holding_a_kept_box(fix, tile)
        steps = steps.cpu()
        assert ((held + ctas - 1) // ctas <= steps).all() and (steps <= held).all(), (r, steps, held)
    assert len(sizes) > 1 and 0 not in sizes


def chain_rows(r, k):
    """At every multiple b of 32 with b + 1 < K: box A at b - 1 (the last
    slot of a tile), B at b (the first slot of the next) and C at b + 1 in
    one grid cell, A over B and B over C at 0.4 in both modes but A not
    over C; every other box alone in its cell. Every candidate but the B's
    is kept. Returns scores, boxes and that mask."""
    side = int(k ** 0.5 + 0.999999)
    cell = torch.arange(k)
    shift = torch.zeros(k, dtype=torch.float64)
    b = torch.arange(32, k - 1, 32)
    cell[b] = b - 1
    cell[b + 1] = b - 1
    shift[b], shift[b + 1] = 0.3, 0.65
    w = 0.3 / side
    y0, x0 = (cell // side).double() / side, (cell % side).double() / side + shift * w
    boxes = torch.stack([y0, x0, y0 + 0.5 / side, x0 + w], -1).float()
    want = torch.ones(k, dtype=torch.bool)
    want[b] = False
    scores = torch.linspace(1.0, 0.01, k)
    return scores.repeat(r, 1).contiguous(), boxes.repeat(r, 1, 1).contiguous(), want.repeat(r, 1)


@pytest.mark.parametrize("mode", ["min", "union"])
def test_nms_chain_across_tile_boundaries_equals_plain(cuda, mode):
    """A suppressor in the last slot of a tile and its target in the first
    of the next: the target's own target is kept. K-A and K-C (capped at 33
    and K) against the plain versions and the closed form, K = 8732."""
    k = 8732
    scores, boxes, want = (t.to(cuda) for t in chain_rows(2, k))
    kernels.reset_launch_counts()
    fix = nms_fixpoint_keep_mask(scores, boxes, 0.4, mode)
    scan = [nms_scan_keep_mask(scores, boxes, 0.4, cap, mode) for cap in (33, k)]
    torch.cuda.synchronize()
    assert nms_fixpoint_keep_mask.launches == 1 and nms_scan_keep_mask.launches == 2
    assert torch.equal(fix, want) and torch.equal(fix, nms_fixpoint_keep_mask_plain(scores, boxes, 0.4, mode))
    ref = nms_scan_keep_mask_plain(scores, boxes, 0.4, k, mode)
    assert torch.equal(ref, want) and torch.equal(scan[1], ref) and torch.equal(scan[0], first_kept(ref, 33))


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("edge", ["disjoint", "identical", "chain"])
def test_nms_cluster_kernel_at_200000_keeps_the_closed_form(cuda, edge, mode):
    """K = 200 000, where no plain version runs: disjoint boxes keep every
    candidate, one box K times keeps one, the chain rows keep all but the
    B's; K-C capped at 200 keeps the first 200 of those, at K all."""
    k = 200_000
    if edge == "chain":
        scores, boxes, want = (t.to(cuda) for t in chain_rows(2, k))
    else:
        scores, boxes = edge_rows(edge, 2, k)
        scores, boxes = scores.to(cuda), boxes.to(cuda)
        want = torch.zeros(2, k, dtype=torch.bool, device=cuda)
        want[:, : k if edge == "disjoint" else 1] = True
    assert cluster_layout(2, k)[0] > 0
    kernels.reset_launch_counts()
    fix = nms_fixpoint_keep_mask(scores, boxes, 0.4, mode)
    scan = [nms_scan_keep_mask(scores, boxes, 0.4, cap, mode) for cap in (200, k)]
    torch.cuda.synchronize()
    assert nms_fixpoint_keep_mask.launches == 1 and nms_scan_keep_mask.launches == 2
    assert torch.equal(fix, want) and torch.equal(scan[1], want) and torch.equal(scan[0], first_kept(want, 200))


@pytest.mark.parametrize("mode", ["min", "union"])
def test_nms_cluster_max_k_on_both_sides(cuda, mode):
    """CLUSTER_MAX_K is the library's: rows of that K take the cluster
    kernel, one wider take `nms_wide_kernel`. The same random row with one
    more candidate of score 0 (never kept, suppressing nothing) gives the
    same mask through both; one box K times keeps one on both sides."""
    assert _build.library().nms_cluster_max_k() == CLUSTER_MAX_K
    k = CLUSTER_MAX_K
    assert cluster_layout(2, k)[0] > 0 and cluster_layout(2, k + 1)[0] == 0
    scores, boxes = (t.to(cuda) for t in sorted_rows(7, 2, k + 1))
    scores[:, k] = 0.0
    narrow_s, narrow_b = scores[:, :k].contiguous(), boxes[:, :k].contiguous()
    kernels.reset_launch_counts()
    pairs = [(nms_fixpoint_keep_mask(narrow_s, narrow_b, 0.4, mode), nms_fixpoint_keep_mask(scores, boxes, 0.4, mode)),
             (nms_scan_keep_mask(narrow_s, narrow_b, 0.4, 200, mode),
              nms_scan_keep_mask(scores, boxes, 0.4, 200, mode))]
    torch.cuda.synchronize()
    assert nms_fixpoint_keep_mask.launches == 2 and nms_scan_keep_mask.launches == 2
    for cluster, wide in pairs:
        assert not wide[:, k].any() and torch.equal(cluster, wide[:, :k]) and cluster.any()
    for kk in (k, k + 1):
        s, b = (t.to(cuda) for t in edge_rows("identical", 2, kk))
        assert nms_fixpoint_keep_mask(s, b, 0.4, mode).sum(-1).tolist() == [1, 1]
        assert nms_scan_keep_mask(s, b, 0.4, kk, mode).sum(-1).tolist() == [1, 1]


def test_nms_takes_a_misaligned_view(cuda):
    """Boxes that start 4 bytes past a 16-byte boundary are copied to an
    aligned tensor before the launch: the plain version's masks."""
    scores, boxes = (t.to(cuda) for t in sorted_rows(14, 6, 200))
    flat = torch.empty(boxes.numel() + 1, device=cuda)
    flat[1:] = boxes.reshape(-1)
    view = flat[1:].view(6, 200, 4)
    assert view.is_contiguous() and view.data_ptr() % 16
    kernels.reset_launch_counts()
    fix = nms_fixpoint_keep_mask(scores, view, 0.4)
    scan = nms_scan_keep_mask(scores, view, 0.4, 100)
    torch.cuda.synchronize()
    assert nms_fixpoint_keep_mask.launches == 1 and nms_scan_keep_mask.launches == 1
    assert torch.equal(fix, nms_fixpoint_keep_mask_plain(scores, boxes, 0.4))
    assert torch.equal(scan, nms_scan_keep_mask_plain(scores, boxes, 0.4, 100))


def bf16_ulp(ref):
    """One bf16 ulp of each bf16-valued entry, 2^(floor(log2 |ref|) - 7); 0 at
    0. The exponent comes from frexp, exact: log2 on the card is not exact at
    powers of two."""
    _, e = torch.frexp(ref)
    return torch.where(ref != 0, torch.ldexp(torch.ones_like(ref), e - 8), 0.0)


def assert_conv_pool_close(got, ref, rounded):
    """The two f32 sums differ in order and cuDNN's f32 algorithm may be
    less exact than a plain sum (measured on an H100: up to ~1e-5 from an
    f64 reference): f32 outputs within 1e-4 * (1 + |ref|). A bf16-rounded
    output rounds those f32 values, so it may land one bf16 ulp further
    apart: within ulp(ref) + 1e-4 * (1 + |ref|). (The f32 term matters only
    near 0, where a sum of a thousand terms cancels to a value whose ulp is
    below the f32 sums' own error.)"""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    g, r = got.double(), ref.double()
    tol = 1e-4 * (1 + r.abs()) + (bf16_ulp(r) if rounded else 0.0)
    bad = (g - r).abs() > tol
    assert not bad.any(), f"{int(bad.sum())} of {bad.numel()} outputs out of tolerance"


CONV_CASES = [
    # (name, shape [B, H, W], Ci, Co)
    ("stem", (32, 320, 320), 64, 64),  # block-1 tail, full width
    ("stem", (2, 36, 52), 64, 64),  # ragged tiles
    ("stem", (2, 36, 52), 8, 8),  # C below one K-step of 16
    ("stem", (2, 36, 52), 96, 96),  # two 64-channel chunks of K and of N
    ("general", (32, 160, 160), 128, 128),  # block-2 tail
    ("general", (32, 80, 80), 256, 256),  # block-3 tail
    ("general", (3, 36, 52), 128, 256),  # ragged, Ci != Co
    ("general", (2, 20, 26), 512, 512),  # 8 64-channel chunks of K and of N
    ("general", (1, 8, 12), 4, 16),  # Ci below one chunk
    ("general", (1, 16, 32), 64, 64),  # one tile: one block of one stage
    ("general", (2, 36, 52), 64, 128),  # one K chunk, two N chunks
    ("general", (2, 36, 52), 192, 64),  # three K chunks: an odd number of stages a block
    ("general", (2, 36, 52), 24, 40),  # channels that fill no chunk
    ("general", (2, 80, 96), 64, 320),  # 150 units on 132 SMs: a second unit, other weights
    ("general", (2, 36, 52), 64, 12),  # Co that is no multiple of 8: padded to 16, cut back
    ("stem", (2, 36, 52), 12, 12),  # C that is no multiple of 8
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,shape,cin,cout", CONV_CASES)
def test_conv_pool_kernels_within_tolerance_of_plain(cuda, name, shape, cin, cout, dtype):
    g = torch.Generator().manual_seed(sum(shape) + cin + cout)
    x = torch.relu(torch.randn(*shape, cin, generator=g) * 3).to(dtype).to(cuda)
    w = (torch.randn(cout, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5).to(cuda)
    b = (torch.randn(cout, generator=g) * 0.1).to(cuda)
    kernel, plain = {
        "stem": (fused_stem_conv_relu_pool2, fused_stem_conv_relu_pool2_plain),
        "general": (fused_conv3x3_relu_pool2, fused_conv3x3_relu_pool2_plain),
    }[name]
    kernels.reset_launch_counts()
    got = kernel(x, w, b)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    ref = plain(x, w, b)
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, cout) and got.dtype == dtype
    assert_conv_pool_close(got, ref, rounded=name == "stem" or dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_block1_grads_match_recompute_composition(cuda, dtype, rel):
    """Gradients through the kernel path exist and equal autograd through
    `block1_reference` (the Function's backward is that composition's VJP).
    Tolerance: rel of each gradient's largest magnitude; cuDNN's weight
    gradients may sum with atomics in another order on each run, which in
    bf16 moves a value by a few bf16 ulps."""
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(2, 36, 52, 3, generator=g) * 60).to(dtype)
    params = [torch.randn(64, 3, 3, 3, generator=g) * 0.1, torch.randn(64, generator=g),
              torch.randn(64, 64, 3, 3, generator=g) * 0.05, torch.randn(64, generator=g)]
    go = torch.randn(2, 18, 26, 64, generator=g).to(dtype).to(cuda)
    grads = []
    for fn in (fused_vgg_block1, block1_reference):
        leaves = [t.to(cuda).requires_grad_() for t in (x, *params)]
        kernels.reset_launch_counts()
        (fn(*leaves) * go).float().sum().backward()
        torch.cuda.synchronize()
        assert fused_vgg_block1.launches == (fn is fused_vgg_block1)
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        assert got is not None and torch.isfinite(got).all()
        scale = float(ref.float().abs().max())
        assert float((got.float() - ref.float()).abs().max()) <= rel * scale


@pytest.mark.parametrize(
    "shape", [(1, 16, 32), (2, 36, 52), (1, 8, 12), (2, 320, 320), (1, 300, 300), (2, 300, 300), (1, 512, 512)]
)
def test_block1_kernel_within_bf16_of_plain(cuda, shape):
    """Tolerance: both round conv1_1 to bf16 and the output to bf16; their
    f32 sums differ in order, so an output may land one bf16 ulp (at most
    2^-7 of its value: rtol) apart, and a conv1_1 value that rounds the
    other way shifts the outputs it feeds by |w2| times its ulp (atol)."""
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(*shape, 3, generator=g) * 60).to(torch.bfloat16).to(cuda)
    w1 = (torch.randn(64, 3, 3, 3, generator=g) * 0.1).to(cuda)
    b1 = torch.randn(64, generator=g).to(cuda)
    w2 = (torch.randn(64, 64, 3, 3, generator=g) * 0.05).to(cuda)
    b2 = torch.randn(64, generator=g).to(cuda)
    kernels.reset_launch_counts()
    got = fused_vgg_block1(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_vgg_block1.launches == 1
    ref = fused_vgg_block1_plain(x, w1, b1, w2, b2)
    assert got.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    torch.testing.assert_close(got.float(), ref.float(), rtol=8e-3, atol=0.1)


BLOCK_WIDTHS = [
    # (shape [B, H, W], Ci, C)
    ((32, 160, 160), 64, 128),  # VGG block 2 at RON-320's width, batch 32
    ((1, 16, 16), 64, 128),  # one 8 x 32 tile, ragged in W
    ((3, 36, 52), 64, 128),  # ragged tiles
    ((3, 36, 52), 8, 8),  # the JAX test's rectangular case: C padded to one chunk of 64
    ((1, 8, 12), 5, 72),  # Ci padded to 8, C to 128
    ((2, 24, 40), 3, 128),  # Ci = 3 past block 1's C: the tensor-core kernel, Ci padded to 8
    ((1, 10, 6), 1, 8),  # block 1's kernel, Ci padded to 3 and C to 64
    ((1, 16, 32), 64, 64),  # one chunk of C
    ((2, 20, 26), 128, 256),  # two chunks of Ci; four of C: conv A recomputed per output chunk
    ((2, 20, 26), 64, 192),  # three 64-channel chunks of C: the general schedule, not the 128-wide one
    ((2, 20, 26), 128, 128),  # two X chunks into the 128-wide schedule
    ((2, 20, 26), 192, 128),  # three X chunks
    ((1, 10, 34), 64, 64),  # ragged in H and W: the last tile row holds 2 of 8 rows, the last column 2 of 32
    ((2, 8, 32), 64, 128),  # two tiles: fewer tiles than SMs
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,cin,c", BLOCK_WIDTHS)
def test_block_kernel_within_bf16_of_plain_at_any_width(cuda, shape, cin, c, dtype):
    """`fused_vgg_block1` at widths other than block 1's, one launch each,
    against its plain version: the tolerance of
    `test_block1_kernel_within_bf16_of_plain`. Activations at post-ReLU
    scale, He-scaled weights."""
    g = torch.Generator().manual_seed(sum(shape) + cin + c)
    x = torch.relu(torch.randn(*shape, cin, generator=g) * 3).to(dtype).to(cuda)
    w1 = (torch.randn(c, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5).to(cuda)
    b1 = (torch.randn(c, generator=g) * 0.1).to(cuda)
    w2 = (torch.randn(c, c, 3, 3, generator=g) * (2.0 / (9 * c)) ** 0.5).to(cuda)
    b2 = (torch.randn(c, generator=g) * 0.1).to(cuda)
    kernels.reset_launch_counts()
    got = fused_vgg_block1(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_vgg_block1.launches == 1
    ref = fused_vgg_block1_plain(x, w1, b1, w2, b2)
    assert got.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, c) and got.dtype == dtype
    assert got.is_contiguous()
    torch.testing.assert_close(got.float(), ref.float(), rtol=8e-3, atol=0.1)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_block2_grads_match_recompute_composition(cuda, dtype, rel):
    """`test_block1_grads_match_recompute_composition` at VGG block 2's
    widths (64 -> 128): the forward through the tensor-core kernel, the
    backward autograd through `block1_reference`."""
    g = torch.Generator().manual_seed(4)
    x = torch.relu(torch.randn(2, 36, 52, 64, generator=g) * 3).to(dtype)
    params = [torch.randn(128, 64, 3, 3, generator=g) * 0.06, torch.randn(128, generator=g) * 0.1,
              torch.randn(128, 128, 3, 3, generator=g) * 0.04, torch.randn(128, generator=g) * 0.1]
    go = torch.randn(2, 18, 26, 128, generator=g).to(dtype).to(cuda)
    grads = []
    for fn in (fused_vgg_block1, block1_reference):
        leaves = [t.to(cuda).requires_grad_() for t in (x, *params)]
        kernels.reset_launch_counts()
        (fn(*leaves) * go).float().sum().backward()
        torch.cuda.synchronize()
        assert fused_vgg_block1.launches == (fn is fused_vgg_block1)
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        assert got is not None and torch.isfinite(got).all()
        scale = float(ref.float().abs().max())
        assert float((got.float() - ref.float()).abs().max()) <= rel * scale


def conv1_1_as_kernel(x, w1, b1):
    """relu(conv1_1(x) + b1) rounded to bf16, summed as the block-1 kernel
    sums it: one f32 accumulator per output, taps (dy, dx, ci) in that order,
    each added as fmaf adds it (a bf16 x bf16 product is exact in f32, so
    fmaf(x, w, acc) is acc + x * w rounded once). NHWC in and out."""
    b, h, w, cin = x.shape
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wb = w1.to(torch.bfloat16).float()  # [C, Ci, 3, 3]
    acc = torch.zeros(b, h, w, wb.shape[0], device=x.device)
    for dy in range(3):
        for dx in range(3):
            for ci in range(cin):
                acc = acc + xp[:, dy:dy + h, dx:dx + w, ci:ci + 1] * wb[:, ci, dy, dx]
    return torch.relu(acc + b1.float()).to(torch.bfloat16)


def test_stem_on_conv1_1_equals_block1_kernel(cuda):
    """K-D on block 1's own conv1_1 map gives K-B's output: both run conv1_2
    through one tensor-core mainloop (`csrc/conv3x3_mma.cuh`), so the sums
    come in one order. Held within one bf16 ulp, as `chip_smoke.py` holds
    them on the main path's batch; a random batch with ragged tiles here."""
    g = torch.Generator().manual_seed(11)
    x = (torch.randn(3, 52, 84, 3, generator=g) * 60).to(torch.bfloat16).to(cuda)
    w1 = (torch.randn(64, 3, 3, 3, generator=g) * 0.1).to(cuda)
    b1 = torch.randn(64, generator=g).to(cuda)
    w2 = (torch.randn(64, 64, 3, 3, generator=g) * 0.05).to(cuda)
    b2 = torch.randn(64, generator=g).to(cuda)
    kernels.reset_launch_counts()
    block1 = fused_vgg_block1(x, w1, b1, w2, b2)
    stem = fused_stem_conv_relu_pool2(conv1_1_as_kernel(x, w1, b1), w2, b2)
    torch.cuda.synchronize()
    assert fused_vgg_block1.launches == 1 and fused_stem_conv_relu_pool2.launches == 1
    g_, r = stem.double(), block1.double()
    assert stem.shape == block1.shape == (3, 26, 42, 64)
    bad = (g_ - r).abs() > bf16_ulp(r)
    assert not bad.any(), f"{int(bad.sum())} of {bad.numel()} outputs more than one bf16 ulp apart"


def test_general_equals_stem_at_64_channels(cuda):
    """K-E on a bf16 x at Ci = Co = 64 is K-D's function, through the same
    kernel and sum order: equal bits."""
    g = torch.Generator().manual_seed(12)
    x = torch.relu(torch.randn(3, 52, 84, 64, generator=g) * 3).to(torch.bfloat16).to(cuda)
    w = (torch.randn(64, 64, 3, 3, generator=g) * 0.06).to(cuda)
    b = (torch.randn(64, generator=g) * 0.1).to(cuda)
    kernels.reset_launch_counts()
    general, stem = fused_conv3x3_relu_pool2(x, w, b), fused_stem_conv_relu_pool2(x, w, b)
    torch.cuda.synchronize()
    assert fused_conv3x3_relu_pool2.launches == 1 and fused_stem_conv_relu_pool2.launches == 1
    assert torch.equal(general, stem)


def test_general_takes_a_misaligned_view(cuda):
    """A bf16 x that starts one element past a 16-byte boundary is copied
    to an aligned tensor before the launch: the plain version's result."""
    g = torch.Generator().manual_seed(13)
    flat = torch.relu(torch.randn(2 * 36 * 52 * 64 + 1, generator=g) * 3).to(torch.bfloat16).to(cuda)
    x = flat[1:].view(2, 36, 52, 64)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = (torch.randn(128, 64, 3, 3, generator=g) * 0.06).to(cuda)
    b = (torch.randn(128, generator=g) * 0.1).to(cuda)
    kernels.reset_launch_counts()
    got = fused_conv3x3_relu_pool2(x, w, b)
    torch.cuda.synchronize()
    assert fused_conv3x3_relu_pool2.launches == 1
    assert_conv_pool_close(got, fused_conv3x3_relu_pool2_plain(x, w, b), rounded=True)


def test_f32_model_ignores_the_tf32_flag(cuda):
    """An f32 RON gives the same bits under torch's default cuDNN TF32 flag
    (True) as with it off: its forward pins full f32 convolutions and
    restores the caller's flag. Without the pin, TF32 moves the f32
    detections of the trained RON-320 out of the 2e-3 gate (PERF.md)."""
    torch.manual_seed(0)
    model = RON(RON_TINY_SPEC).to(cuda).eval()
    images = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1)).to(cuda) * 50
    outs = {}
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            with torch.inference_mode():
                outs[flag] = model(images)
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = False
    for name, a, b in zip(outs[True]._fields, outs[True], outs[False]):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("method", ["auto", "loop", "fixpoint", "pallas"])
def test_detector_nms_method_launches_its_kernel(cuda, method):
    """The tiny RON's outputs through the Detector on the card: 'pallas'
    and 'auto' launch K-A, JAX's 'loop' and 'fixpoint' K-C, once a call and
    nothing else; the detections equal the CPU Detector's with the same
    kernel's plain version on the same outputs."""
    torch.manual_seed(0)
    model = RON(RON_TINY_SPEC).to(cuda).eval()
    images = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1)).to(cuda) * 50
    det = Detector(model, RON_TINY_SPEC, DetectionConfig(nms_method=method, objectness_threshold=0.0), device="cuda")
    with torch.inference_mode():
        out = det.model(images)
        kernels.reset_launch_counts()
        got = [t.cpu() for t in det.postprocess(out)]
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        cpu_cfg = DetectionConfig(nms_method="pallas" if method == "auto" else method, objectness_threshold=0.0)
        ref = Detector(RON(RON_TINY_SPEC), RON_TINY_SPEC, cpu_cfg, device="cpu").postprocess(
            type(out)(*(t.cpu() for t in out)))
    assert launched == ({"nms_fixpoint_keep_mask": 1} if method in ("auto", "pallas") else {"nms_scan_keep_mask": 1})
    assert bool((got[0] > 0).any())
    assert torch.equal((got[0] > 0).sum(-1), (ref[0] > 0).sum(-1))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    scores, boxes = (t.to(cuda) for t in sorted_rows(0, 2, 8))
    with pytest.raises(TypeError):
        nms_fixpoint_keep_mask(scores.double(), boxes.double())
    with pytest.raises(ValueError):
        nms_fixpoint_keep_mask(scores[:, ::2], boxes[:, ::2])
    x = torch.zeros(1, 7, 8, 3, dtype=torch.bfloat16, device=cuda)
    w1, w2 = torch.zeros(64, 3, 3, 3, device=cuda), torch.zeros(64, 64, 3, 3, device=cuda)
    b = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):
        fused_vgg_block1(x, w1, b, w2, b)  # odd height
    x2 = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16, device=cuda)
    w21, w22 = torch.zeros(128, 64, 3, 3, device=cuda), torch.zeros(128, 128, 3, 3, device=cuda)
    b2 = torch.zeros(128, device=cuda)
    with pytest.raises(ValueError):
        fused_vgg_block1(x2[:, :, :7], w21, b2, w22, b2)  # odd width
    with pytest.raises(TypeError):
        fused_vgg_block1(x2.half(), w21, b2, w22, b2)
    with pytest.raises(ValueError):
        fused_vgg_block1(x2, w21.cpu(), b2, w22, b2)  # weights on another device
    with pytest.raises(ValueError):
        fused_vgg_block1(x2, w21, b2, w22[:, :64], b2)  # w2 not [C, C, 3, 3]
    with pytest.raises(ValueError):
        nms_scan_keep_mask(scores[:, ::2], boxes[:, ::2])
    wide = [t.to(cuda) for t in sorted_rows(1, 2, MAX_K + 1)]  # K > MAX_K: the wide-row path, no longer refused
    assert nms_scan_keep_mask(*wide).shape == nms_fixpoint_keep_mask(*wide).shape == (2, MAX_K + 1)
    taken = [t.to(cuda) for t in sorted_rows(1, 2, 2048)]  # past the old limit of 1024
    assert nms_scan_keep_mask(*taken).shape == nms_fixpoint_keep_mask(*taken).shape == (2, 2048)
    with pytest.raises(ValueError):
        nms_scan_keep_mask(scores, boxes.cpu())  # two devices
    xc = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16, device=cuda)
    wc, bc = torch.zeros(64, 64, 3, 3, device=cuda), torch.zeros(64, device=cuda)
    for fn in (fused_stem_conv_relu_pool2, fused_conv3x3_relu_pool2):
        with pytest.raises(ValueError):
            fn(xc[:, :7], wc, bc)  # odd height
        with pytest.raises(ValueError):
            fn(xc[:, :, :7], wc, bc)  # odd width
        with pytest.raises(ValueError):
            fn(xc, wc.cpu(), bc)  # weights on another device
        with pytest.raises(TypeError):
            fn(xc.half(), wc, bc)
    with pytest.raises(ValueError):
        fused_stem_conv_relu_pool2(xc, torch.zeros(128, 64, 3, 3, device=cuda), torch.zeros(128, device=cuda))
    assert fused_conv3x3_relu_pool2(xc, torch.zeros(128, 64, 3, 3, device=cuda),
                                    torch.zeros(128, device=cuda)).shape == (1, 4, 4, 128)


@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("r", [1, 32])
def test_nms_scan_kernel_equals_plain_on_realtime_rows(cuda, r, flags):
    """K-C at the realtime head's rows, [B, 400], union, cap 20 (the
    block-per-row path, K > 256). flags: the rows the head gives it, valid
    flags 1.0 / 0.0 as scores."""
    scores, boxes = (t.to(cuda) for t in sorted_rows(r + 400, r, 400, 8 if flags else None))
    if flags:
        scores = (scores > 0).float()
    kernels.reset_launch_counts()
    got = nms_scan_keep_mask(scores, boxes, 0.4, 20, "union")
    torch.cuda.synchronize()
    assert nms_scan_keep_mask.launches == 1
    assert torch.equal(got, nms_scan_keep_mask_plain(scores, boxes, 0.4, 20, "union"))
    assert int(got.sum(-1).max()) == 20


@pytest.mark.parametrize("class_wise", [False, True])
def test_tiny_realtime_head_on_card_equals_cpu(cuda, class_wise):
    """The realtime head's postprocess on the card (through K-C, never K-A)
    against the same call on the CPU, on one tiny RON's outputs: equal
    labels and valid flags, scores and boxes within 1e-5 (the card's exp in
    the box decode may differ from the CPU's by an ulp)."""
    torch.manual_seed(0)
    model = RON(RON_TINY_SPEC).eval()
    images = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(2)) * 50
    cfg = RealtimeConfig(objectness_threshold=0.0, select_threshold=0.01, top_k=64, keep_top_k=16,
                         class_wise=class_wise, keep_per_class=10)
    min_size = torch.tensor([0.03, 0.05, 0.02])
    with torch.inference_mode():
        out = model(images)
        ref = RealtimeDetector(model, RON_TINY_SPEC, cfg, device="cpu").postprocess(out, min_size)
        det = RealtimeDetector(model, RON_TINY_SPEC, cfg, device="cuda")
        kernels.reset_launch_counts()
        got = det.postprocess(type(out)(*(t.to(cuda) for t in out)), min_size.to(cuda))
        torch.cuda.synchronize()
    assert nms_scan_keep_mask.launches >= 1 and nms_fixpoint_keep_mask.launches == 0
    got = [t.cpu() for t in got]
    assert torch.equal(got[3], ref[3]) and torch.equal(got[1], ref[1]) and bool(ref[3].any())
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-5)


def test_matcher_on_card_equals_cpu(cuda):
    """match_all_classes on [B, C-1, K] stacks on the card: the CPU's marks."""
    g = torch.Generator().manual_seed(5)
    b, c, k, n_gt = 4, 21, 100, 12
    gboxes = torch.sort(torch.rand(b, n_gt, 2, 2, generator=g), dim=2).values.transpose(2, 3).reshape(b, n_gt, 4)
    glabels = torch.randint(0, c, (b, n_gt), generator=g, dtype=torch.int32)
    gdiff = torch.rand(b, n_gt, generator=g) < 0.2
    src = torch.randint(0, n_gt, (b, c - 1, k), generator=g)
    boxes = torch.gather(gboxes[:, None].expand(b, c - 1, n_gt, 4), 2, src[..., None].expand(-1, -1, -1, 4))
    boxes = boxes + torch.randn(b, c - 1, k, 4, generator=g) * 0.03
    scores = torch.sort(torch.rand(b, c - 1, k, generator=g), dim=-1, descending=True).values
    ref = match_all_classes(c, scores, boxes, glabels, gboxes, gdiff)
    got = match_all_classes(c, *(t.to(cuda) for t in (scores, boxes, glabels, gboxes, gdiff)))
    assert bool(ref.tp.any()) and bool(ref.fp.any())
    for name, a, r in zip(got._fields, got, ref):
        assert torch.equal(a.cpu(), r), name


def tiny_train_setup(device, dtype=torch.float32, fuse_block1=False):
    """A tiny RON initialized as flax does (seed 0), its encoder, optimizer,
    state and train step, on `device`."""
    model = RON(RON_TINY_SPEC, dtype=dtype, fuse_block1=fuse_block1)
    init_like_flax_(model, torch.Generator().manual_seed(0))
    model.to(device)
    enc = TargetEncoder(RON_TINY_SPEC.anchor_layout(), RON_TINY_SPEC.img_shape, 0.5, 0.3)
    tx = make_optimizer(OptimizerConfig(learning_rate=1e-3, learning_rate_decay_type="fixed"), model)
    state = create_train_state(model, tx)
    return model, state, make_train_step(model, enc, tx)


def tiny_train_batch(device):
    g = torch.Generator().manual_seed(3)
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.5], [0.4, 0.3, 0.9, 0.8]]]).repeat(4, 1, 1)
    batch = {"image": (torch.rand(4, 64, 64, 3, generator=g) * 255 - 120) * torch.rand(4, 1, 1, 1, generator=g),
             "gt_labels": torch.tensor([[3, 9]] * 4, dtype=torch.int32), "gt_boxes": boxes,
             "gt_valid": torch.tensor([[True, True], [True, False]] * 2)}
    draws = torch.rand(2, 4, RON_TINY_SPEC.anchor_layout().num_anchors, generator=g)
    return {k: v.to(device) for k, v in batch.items()}, draws.to(device)


def keep_first(store, key, grad):
    """A tensor hook: keeps the first gradient under `key`, changes nothing."""
    store.setdefault(key, grad.clone())


def test_f32_train_step_gradients_ignore_the_tf32_flag(cuda):
    """The f32 train step's gradients are the same bits under torch's default
    cuDNN TF32 flag (True) as with it off: forward and backward run inside
    full_f32_convs, and the caller's flag comes back. cuDNN is asked for
    deterministic algorithms, so that two runs can be equal at all."""
    batch, draws = tiny_train_batch(cuda)
    grads, losses = {}, {}
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for flag in (True, False):
            model, state, step = tiny_train_setup(cuda)
            seen = {}
            for name, p in model.named_parameters():
                p.register_hook(functools.partial(keep_first, seen, name))
            torch.backends.cudnn.allow_tf32 = flag
            _, metrics = step(state, batch, draws=draws)
            torch.cuda.synchronize()
            assert torch.backends.cudnn.allow_tf32 is flag
            grads[flag], losses[flag] = seen, float(metrics["loss/total"])
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    assert losses[True] == losses[False]
    assert grads[True].keys() == grads[False].keys() and len(grads[True]) == len(list(model.parameters()))
    for name in grads[True]:
        assert torch.equal(grads[True][name], grads[False][name]), name


def test_tiny_bf16_train_step_on_card_launches_kb_and_matches_cpu(cuda):
    """One bf16 train step with block 1 fused: on the card K-B is launched
    once (its recompute backward is cuDNN), on the CPU its plain version
    runs. The positives are equal, the loss and gradient norm within 5e-2
    (bf16 rounds at other places on the two devices, and train-mode
    BatchNorm and the ReLUs amplify it)."""
    batch, draws = tiny_train_batch("cpu")
    ref = make_and_step("cpu", batch, draws)
    kernels.reset_launch_counts()
    got = make_and_step(cuda, {k: v.to(cuda) for k, v in batch.items()}, draws.to(cuda))
    torch.cuda.synchronize()
    assert fused_vgg_block1.launches == 1
    assert sum(kernels.launch_counts().values()) == 1
    assert float(got["counts/positives"]) == float(ref["counts/positives"]) > 0
    for k in ("loss/total", "loss/objectness", "loss/classification", "grad_norm"):
        assert abs(float(got[k]) - float(ref[k])) <= 5e-2 * abs(float(ref[k])), k


def make_and_step(device, batch, draws):
    model, state, step = tiny_train_setup(device, torch.bfloat16, fuse_block1=True)
    _, metrics = step(state, batch, draws=draws)
    return metrics


def test_ssd300_fused_block1_through_the_detector_on_card(cuda):
    """SSD-300 in bf16 with fuse_block1, batch 2, through the Detector with
    the SSD eval preset's values (select 0.01, objectness 0, top-k 400, keep
    200, 'min' NMS 0.45): K-B and K-A launched once each, K-B's output at
    300x300 (ragged tiles) within bf16 of its plain version; the card's
    postprocess of its own outputs against the CPU Detector's (plain NMS) on
    the same outputs copied to the host: equal keep counts, scores and boxes
    within 1e-5 (the card's exp in the box decode may differ by an ulp)."""
    model, spec = get_network("ssd_300_vgg", dtype=torch.bfloat16, fuse_block1=True)
    params, _ = seeded_flax_params(model, seed=3)
    model.load_state_dict(from_jax_params(params, {}), strict=True)
    cfg = DetectionConfig(select_threshold=0.01, objectness_threshold=0.0, top_k=400, keep_top_k=200,
                          nms_threshold=0.45, nms_method="pallas")
    det = Detector(model, spec, cfg, device="cuda")
    images = (torch.rand(2, 300, 300, 3, generator=torch.Generator().manual_seed(4)) * 255 - 120).to(cuda)
    kernels.reset_launch_counts()
    scores, boxes = det(images)
    torch.cuda.synchronize()
    assert fused_vgg_block1.launches == 1 and nms_fixpoint_keep_mask.launches == 1
    assert scores.shape == (2, 20, 200) and boxes.shape == (2, 20, 200, 4) and bool((scores > 0).any())
    with torch.inference_mode():
        x = images.to(torch.bfloat16).contiguous()
        c1, c2 = model.conv1_1.conv, model.conv1_2.conv
        torch.testing.assert_close(fused_vgg_block1(x, c1.weight, c1.bias, c2.weight, c2.bias).float(),
                                   fused_vgg_block1_plain(x, c1.weight, c1.bias, c2.weight, c2.bias).float(),
                                   rtol=8e-3, atol=0.1)
        out = det.model(images)
        got = [t.cpu() for t in det.postprocess(out)]
        cpu_model, _ = get_network("ssd_300_vgg")
        ref = Detector(cpu_model, spec, cfg, device="cpu").postprocess(type(out)(*(t.cpu() for t in out)))
    assert torch.equal((got[0] > 0).sum(-1), (ref[0] > 0).sum(-1))
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("side", [8, 9], ids=["even", "odd"])
def test_zoo_pools_on_card_equal_cpu(cuda, side):
    """The XLA-'SAME' pools (the -inf pad after only, on an even side at
    stride 2; averages with and without the padding) on the card: max pools
    equal, averages within float32 rounding."""
    from ron_tensorflow_tpu_torch.models.layers import avg_pool, max_pool

    x = torch.randn(2, 5, side, side + 1, generator=torch.Generator().manual_seed(side))
    for stride in ((1, 1), (2, 2)):
        assert torch.equal(max_pool(x.to(cuda), (3, 3), stride).cpu(), max_pool(x, (3, 3), stride))
        for inc in (True, False):
            torch.testing.assert_close(avg_pool(x.to(cuda), (3, 3), stride, count_include_pad=inc).cpu(),
                                       avg_pool(x, (3, 3), stride, count_include_pad=inc), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_zoo_network_on_card_equals_cpu(cuda, train):
    """Xception with one middle block at 75x75 (its pools see odd and even
    sides), f32, seeded weights: logits and endpoints within 1e-4 of each
    one's largest magnitude of the CPU's; in train mode the running
    statistics too. No port kernel is launched."""
    from ron_tensorflow_tpu_torch.models import Xception

    model = Xception(num_classes=10, middle_blocks=1)
    model.load_state_dict(from_jax_params(*seeded_flax_params(model, 3, gain=2 ** 0.5, bn_mean_std=0.5)))
    card = Xception(num_classes=10, middle_blocks=1).to(cuda)
    card.load_state_dict(model.state_dict())
    x = torch.rand(2, 75, 75, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1
    kernels.reset_launch_counts()
    with torch.no_grad():
        want, want_eps = model(x, train=train)
        got, got_eps = card(x.to(cuda), train=train)
    assert sum(kernels.launch_counts().values()) == 0
    for g, w in [(got, want)] + [(got_eps[k], v) for k, v in want_eps.items()]:
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4 * float(w.abs().max()))
    for (name, g), w in zip(card.named_buffers(), model.buffers()):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4 * float(w.abs().max()), msg=name)


def test_profile_trace_on_card_holds_kernels(cuda, tmp_path):
    import json

    from ron_tensorflow_tpu_torch.utils.profiling import profile_trace

    a = torch.randn(256, 256, device=cuda)
    with profile_trace(str(tmp_path)):
        (a @ a).relu_()
        torch.cuda.synchronize()
    (trace,) = list(tmp_path.glob("*.pt.trace.json"))
    assert any(e.get("cat") == "kernel" for e in json.loads(trace.read_text())["traceEvents"])


def test_tiny_rehearsal_on_card_launches_ka_and_kc(cuda, tmp_path, monkeypatch):
    """The dress rehearsal end to end on the card at a tiny size (RON-tiny,
    8 + 4 images, 2 bf16 steps, K-B off as in the JAX tool): the streaming
    evaluator runs K-A (shared_top_k, 'auto'), the realtime evaluator K-C;
    then the A/B: its K-C variants ('loop', 'fixpoint') agree with the
    exact run, and its two K-A preselection variants with each other."""
    from ron_tensorflow_tpu_torch.eval import StreamingEvaluator
    from ron_tensorflow_tpu_torch.eval.realtime import RealtimeEvaluator
    from ron_tensorflow_tpu_torch.tools import ab_detection_config as ab
    from ron_tensorflow_tpu_torch.tools import dress_rehearsal as dr

    for k, v in {"DR_MODEL": "ron_tiny_vgg", "DR_TRAIN": "8", "DR_TEST": "4", "DR_STEPS": "2", "DR_BATCH": "2",
                 "DR_CROWDED": "1", "AB_MAX_BOXES": "56"}.items():
        monkeypatch.setenv(k, v)
    counts = {}

    def counted(cls, name, label):
        fn = getattr(cls, name)

        def wrapper(*args, **kwargs):
            before = kernels.launch_counts()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            counts.setdefault(label, []).append({k: n - before[k] for k, n in kernels.launch_counts().items()})
            return out

        monkeypatch.setattr(cls, name, wrapper)

    counted(StreamingEvaluator, "run", "streaming")
    counted(RealtimeEvaluator, "evaluate_voc", "realtime")
    assert dr.main([str(tmp_path)]) == 1  # 2 steps: the mAP gate fails, the run does not
    result = json.loads((tmp_path / "result.json").read_text())
    assert tuple(result) == dr.RESULT_KEYS and result["steps"] == 2
    (stream,), (realtime,) = counts["streaming"], counts["realtime"]
    assert stream["nms_fixpoint_keep_mask"] == 1 and stream["nms_scan_keep_mask"] == 0
    assert realtime["nms_scan_keep_mask"] == 1 and realtime["nms_fixpoint_keep_mask"] == 0
    assert stream["fused_vgg_block1"] == realtime["fused_vgg_block1"] == 0
    out = ab.main([str(tmp_path), "ron_tiny_vgg"])
    per_variant = dict(zip(ab.VARIANTS, counts["streaming"][1:]))
    for name, launched in per_variant.items():
        kernel = "nms_scan_keep_mask" if ab.VARIANTS[name].nms_method in ("loop", "fixpoint") else \
            "nms_fixpoint_keep_mask"
        assert launched[kernel] == 1 and sum(launched.values()) == 1, (name, launched)
    m = out["map07"]
    assert m["approx_top_k only"] == m["fixpoint NMS"] == m[ab.EXACT]
    assert m["presel + pallas NMS"] == m["presel shared_top_k=1000"]
