"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a CUDA device every test here skips. This file
imports torch and the port only, so it runs on a GPU host without JAX:
`python -m pytest tests/test_torch_cuda.py -m cuda`.
"""

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
from ron_tensorflow_tpu_torch.kernels.nms import MAX_K
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC

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
@pytest.mark.parametrize("k", [200, MAX_K])
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
    "shape", [(1, 16, 32), (2, 36, 52), (1, 8, 12), (2, 320, 320), (1, 300, 300), (1, 512, 512)]
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
    with pytest.raises(ValueError):
        nms_scan_keep_mask(scores[:, ::2], boxes[:, ::2])
    over = [t.to(cuda) for t in sorted_rows(1, 2, MAX_K + 1)]
    with pytest.raises(ValueError):
        nms_scan_keep_mask(*over)  # K > MAX_K
    with pytest.raises(ValueError):
        nms_fixpoint_keep_mask(*over)
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
