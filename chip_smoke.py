"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each ending with a line that gives its elapsed seconds:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    the port's five CUDA kernels, one nvcc call; ptxas's registers
              and spills and the HGMMA count in the SASS of each
              instantiation of the tensor-core kernels (K-B; K-D and K-E,
              which share one kernel: bf16 or f32 store, weights resident
              or streamed);
  3. kernels  each kernel against its plain PyTorch version on the card, at
              edge shapes (NMS: random, exact-threshold, K = 1024, 2048 and
              4096 rows, a NaN first score, keep_top_k 0, disjoint boxes
              (all kept), identical ones (one kept) and overlaps within a
              few ulps of the threshold; conv: ragged tiles, f32 and bf16
              inputs);
  4. main     full-width RON-320 with the trained weights packed in
              tests/fixtures/e2e_parity_trained.npz, pixels to boxes:
              (a) float32, TF32 off, against the fixture's reference
              detections, through the fixpoint NMS (the Detector's) and
              again through `nms_sorted_kernel(method='scan')`, then once
              more under torch's default flags (cuDNN TF32 on); (b) bf16
              detections of the four images against the f32 ones, with
              block 1 unfused (cuDNN) and through K-B; (c) bf16, batch 32,
              fused block 1, through K-A and K-B (launch counts read around
              this run: K-C, K-D and K-E stay at 0);
  5. api      the kernels API on the main path's own data (counts read
              around it): K-C on the bf16 run's NMS candidates, K-D on
              relu(conv1_1) of its batch with conv1_2's weights, K-E on the
              VGG block-2 and block-3 tails; each output against its plain
              version, and K-D against K-B on the same batch;
  6. grad     K-B's gradients (kernel forward, recompute backward) against
              autograd through the unfused composition, bf16, batch 32;
  7. timing   the bf16 batch-32 Detector's images/s and stage split, each
              kernel's time beside its plain version's, its bound and a
              library yardstick (K-E also tail by tail; the NMS kernels by
              their device time in a torch.profiler trace, with the
              wrapper's per-call time beside it), and one torch.profiler pass
              over a Detector batch (top device kernels, device busy share).
Then one JSON line with the kernels' numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed phase raises: exit code != 0 and
no result line. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ron_tensorflow_tpu_torch import kernels
from ron_tensorflow_tpu_torch.data.preprocess import eval_preprocess
from ron_tensorflow_tpu_torch.inference.detector import TOPK_CHUNKS, DetectionConfig, Detector
from ron_tensorflow_tpu_torch.kernels import _build
from ron_tensorflow_tpu_torch.kernels.fused_conv_pool import block1_reference
from ron_tensorflow_tpu_torch.kernels.nms import (
    MAX_K,
    compact_keep,
    fixpoint_keep,
    nms_sorted_kernel,
    suppression_matrix,
)
from ron_tensorflow_tpu_torch.models.layers import max_pool_2x2
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC
from ron_tensorflow_tpu_torch.ops.math import exact_top_k_chunked
from ron_tensorflow_tpu_torch.tools.time_nms import device_ms
from ron_tensorflow_tpu_torch.weights import from_jax_params, load_trained_fixture

REPO = Path(__file__).resolve().parent
TRAINED_FIXTURE = REPO / "tests" / "fixtures" / "e2e_parity_trained.npz"
IMAGES = ("1", "2", "3", "4")
BATCH = 32
NMS_CFG = DetectionConfig()  # the streaming-eval defaults: thr 0.4, 'min', top_k 200
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# Kernel against plain version, bf16 output: both round conv1_1 and the
# output to bf16 but sum in another order, so an output may land one bf16
# ulp apart (at most 2^-7 of its value: rtol), and a conv1_1 value that
# rounds the other way shifts the outputs it feeds by |w2| times its ulp
# (atol, for outputs near 0). A dropped tap or input channel moves outputs
# by ~1-2%, well past rtol.
BLOCK1_RTOL, BLOCK1_ATOL = 8e-3, 0.1
PARITY_ATOL = 2e-3  # tests/test_e2e_parity.py's tolerance on scores and boxes
# K-D/K-E against their plain versions: the f32 sums differ in order, within
# CONV_F32_TOL * (1 + |plain|); a bf16-rounded output may land one bf16 ulp
# further apart (see conv_err).
CONV_F32_TOL = 1e-4
# K-B's gradients against autograd through the unfused composition, as a
# share of each gradient's largest magnitude: the backward IS that
# composition's VJP, but cuDNN's bf16 weight gradients may sum with atomics
# in another order on each run, a few bf16 ulps (2^-8 each).
GRAD_REL_TOL = 2e-2
SCAN_KEEP_TOP_K = [16, 100, 200]  # K-C's cap in the edge-shape checks
NMS_SOURCE = "ron_tensorflow_tpu_torch/csrc/nms_greedy.cu"  # K-A and K-C: one greedy sweep
# The kernels that run on the tensor cores: wrapper name -> {instantiation:
# a part of its mangled name}. K-D and K-E launch one kernel templated on the
# store type (uint16_t, "t", holds bf16; "f" f32) and on whether its weights
# stream (Lb1: Ci or Co above 64) or stay resident (Lb0).
CONV_MMA = "conv3x3_relu_pool2_mma_kernel"
CONV_MMA_INSTANTIATIONS = {"bf16 out, resident weights": CONV_MMA + "ItLb0E",
                           "bf16 out, streamed weights": CONV_MMA + "ItLb1E",
                           "f32 out, resident weights": CONV_MMA + "IfLb0E",
                           "f32 out, streamed weights": CONV_MMA + "IfLb1E"}
TENSOR_CORE_KERNELS = {
    "fused_vgg_block1": {"bf16 out": "fused_vgg_block1_kernel"},
    "fused_stem_conv_relu_pool2": {k: v for k, v in CONV_MMA_INSTANTIATIONS.items() if k.startswith("bf16")},
    "fused_conv3x3_relu_pool2": CONV_MMA_INSTANTIATIONS,
}


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def smi_sample():
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


@contextlib.contextmanager
def torch_default_flags():
    """torch's default precision flags inside the block: cuDNN f32
    convolutions in TF32, f32 matmuls in full f32."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def tensor_core_report():
    """For each instantiation of each tensor-core kernel: ptxas's registers
    and spills, its dynamic shared memory and the HGMMA instructions in its
    SASS (`cuobjdump -sass` on the built library, where the toolkit has it).
    Fails if an instantiation was built without HGMMA."""
    ptxas = _build.ptxas_report()
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    hgmma = None
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        hgmma, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                hgmma[fn] = 0
            elif fn is not None and "HGMMA" in line:
                hgmma[fn] += 1
    lib = _build.library()
    report = {}
    for name, instantiations in TENSOR_CORE_KERNELS.items():
        smem = getattr(lib, f"{name}_smem_bytes")()
        report[name] = {"tensor_cores": {}}
        for label, kernel in instantiations.items():
            (mangled,) = [n for n in ptxas if kernel in n]
            info = {**ptxas[mangled], "smem_bytes": smem, "hgmma": None if hgmma is None else hgmma[mangled]}
            print(f"  {name} {label} ({mangled}): {info['registers']} registers, {info['spill_stores']} bytes "
                  f"spill stores, {info['spill_loads']} bytes spill loads, {smem} bytes dynamic shared memory, "
                  f"HGMMA in SASS: {info['hgmma'] if hgmma is not None else 'not measured (no cuobjdump)'}")
            if info["hgmma"] == 0:
                raise AssertionError(f"{mangled} holds no HGMMA instruction")
            report[name]["tensor_cores"][label] = info
    return report


def bound(nbytes, flops, peak_flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sorted_rows(seed, r, k, grid=None):
    """Score-sorted NMS rows on the card; grid=g snaps boxes to multiples of
    1/g, so overlaps land exactly on thresholds such as 0.5."""
    g = torch.Generator().manual_seed(seed)
    cy, cx = torch.rand(2, r, k, generator=g) * 0.6 + 0.2
    h, w = torch.rand(2, r, k, generator=g) * 0.35 + 0.05
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    if grid:
        boxes = torch.round(boxes * grid) / grid
    scores = torch.where(torch.rand(r, k, generator=g) < 0.2, 0.0, torch.rand(r, k, generator=g))
    scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return scores.cuda().contiguous(), boxes.cuda().contiguous()


def edge_rows(edge, r, k):
    """NMS rows at the sweep's edges: 'nan first' (random rows whose first
    score is NaN, as a descending sort puts it: the valid candidates are no
    prefix), 'disjoint' (boxes in disjoint grid cells: all K kept, the
    longest chain of steps), 'identical' (one box K times: one kept) and
    'borderline' (box 0 against boxes shifted by float32 ulps so that their
    overlap with it lies within a few ulps of 0.4, the threshold these rows
    are run at, in 'min' mode for the even ones and in 'union' mode for the
    odd ones: the pairs that K-C's kernel decides by dividing)."""
    scores = torch.linspace(1.0, 0.01, k).repeat(r, 1).cuda()
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
    return scores.contiguous(), boxes.cuda().contiguous()


def check_nms(label, scores, boxes, thr, mode, caps, errs):
    """Both NMS kernels against their plain versions on one row set: K-A,
    and K-C at each cap. Returns K-A's mask."""
    got = kernels.nms_fixpoint_keep_mask(scores, boxes, thr, mode)
    ref = kernels.nms_fixpoint_keep_mask_plain(scores, boxes, thr, mode)
    torch.cuda.synchronize()
    err, n_diff = mask_err(got, ref)
    errs["nms_fixpoint_keep_mask"] = max(errs["nms_fixpoint_keep_mask"], err)
    r, k = scores.shape
    print(f"  nms_fixpoint_keep_mask {label} [{r},{k}] {mode}: {n_diff} mask differences, "
          f"{int(ref.sum())} kept")
    if n_diff:
        raise AssertionError(f"NMS keep masks differ ({label}, {mode})")
    kept = []
    for cap in caps:
        got_c = kernels.nms_scan_keep_mask(scores, boxes, thr, cap, mode)
        ref_c = kernels.nms_scan_keep_mask_plain(scores, boxes, thr, cap, mode)
        torch.cuda.synchronize()
        err, n_diff = mask_err(got_c, ref_c)
        errs["nms_scan_keep_mask"] = max(errs["nms_scan_keep_mask"], err)
        if n_diff:
            raise AssertionError(f"scan NMS keep masks differ ({label}, {mode}, keep_top_k {cap}): {n_diff}")
        kept.append(int(ref_c.sum()))
    print(f"  nms_scan_keep_mask {label} [{r},{k}] {mode}, keep_top_k {list(caps)}: "
          f"0 mask differences, {kept} kept")
    return ref


def mask_err(got, ref):
    """Largest |kernel - plain| over a keep mask (0 or 1), and the number
    of entries that differ."""
    diff = (got.int() - ref.int()).abs()
    return float(diff.max()), int(diff.sum())


def block1_err(label, got, ref):
    """Check the block-1 kernel's output against its plain version; return
    max |kernel - plain|."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    used = float((diff / (BLOCK1_ATOL + BLOCK1_RTOL * ref.abs())).max())
    print(f"  fused_vgg_block1 {label}: max |kernel - plain| = {float(diff.max()):.6g} "
          f"(max |plain| = {float(ref.abs().max()):.6g}), {int((diff > 0).sum())} of {diff.numel()} differ, "
          f"{used:.3f} of the tolerance used")
    torch.testing.assert_close(got, ref, rtol=BLOCK1_RTOL, atol=BLOCK1_ATOL)
    return float(diff.max())


def bf16_ulp(ref):
    """One bf16 ulp of each bf16-valued entry, 2^(floor(log2 |ref|) - 7); 0 at
    0. The exponent comes from frexp, exact: log2 on the card is not exact at
    powers of two."""
    _, e = torch.frexp(ref)
    return torch.where(ref != 0, torch.ldexp(torch.ones_like(ref), e - 8), 0.0)


def conv_err(label, got, ref, rounded, f32_tol=CONV_F32_TOL):
    """Check a K-D/K-E output against its reference: |diff| within
    f32_tol * (1 + |ref|), plus one bf16 ulp of ref where the output is
    rounded to bf16. Returns max |diff|."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype} vs {tuple(ref.shape)} {ref.dtype}")
    g, r = got.double(), ref.double()
    diff = (g - r).abs()
    tol = f32_tol * (1 + r.abs()) + (bf16_ulp(r) if rounded else 0.0)
    used = float(torch.where(diff > 0, diff / tol, 0.0).max())  # inf where tol is 0 and diff is not
    print(f"  {label}: max |kernel - ref| = {float(diff.max()):.6g} (max |ref| = {float(r.abs().max()):.6g}), "
          f"{int((diff > 0).sum())} of {diff.numel()} differ, {used:.3f} of the tolerance used")
    if used > 1.0:
        raise AssertionError(f"{label}: {int((diff > tol).sum())} outputs out of tolerance")
    return float(diff.max())


def conv_case(seed, shape, cin, cout, dtype):
    """Random NHWC activations (post-ReLU scale) and He-scaled OIHW weights."""
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(*shape, cin, generator=g) * 3).to(dtype).cuda()
    w = (torch.randn(cout, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5).cuda()
    b = (torch.randn(cout, generator=g) * 0.1).cuda()
    return x, w, b


CONV_KERNELS = {
    "fused_stem_conv_relu_pool2": (kernels.fused_stem_conv_relu_pool2, kernels.fused_stem_conv_relu_pool2_plain),
    "fused_conv3x3_relu_pool2": (kernels.fused_conv3x3_relu_pool2, kernels.fused_conv3x3_relu_pool2_plain),
}


def check_kernels(block1_weights):
    """Phase 3: every kernel against its plain version on the card."""
    errs = {"nms_fixpoint_keep_mask": 0.0, "nms_scan_keep_mask": 0.0}
    for label, (r, k, grid, thr) in {
        "main-path shape": (BATCH * 20, NMS_CFG.top_k, None, NMS_CFG.nms_threshold),
        "exact-threshold grid": (64, NMS_CFG.top_k, 8, 0.5),
        "K=1024": (8, 1024, 4, 0.25),
        "K=2048": (16, 2048, 4, 0.25),
        f"K={MAX_K}": (8, MAX_K, 4, 0.25),
    }.items():
        for mode in ("min", "union"):
            check_nms(label, *sorted_rows(r + k, r, k, grid), thr, mode, SCAN_KEEP_TOP_K, errs)
    for edge, want in (("nan first", None), ("disjoint", "all"), ("identical", 1), ("borderline", None)):
        for k in (NMS_CFG.top_k, MAX_K):
            for mode in ("min", "union"):
                scores, boxes = edge_rows(edge, 4, k)
                keep = check_nms(edge, scores, boxes, NMS_CFG.nms_threshold, mode, (0, 100, k), errs)
                kept = keep.sum(-1)
                if want is not None and not bool((kept == (k if want == "all" else want)).all()):
                    raise AssertionError(f"{edge} rows at K={k}: kept {kept.tolist()}, expected {want} a row")
                if edge == "nan first" and bool(keep[:, 0].any()):
                    raise AssertionError("a NaN score was kept")

    for name, shape, cin, cout in (
        ("fused_stem_conv_relu_pool2", (2, 36, 52), 64, 64),  # ragged tiles
        ("fused_conv3x3_relu_pool2", (3, 36, 52), 128, 256),  # ragged, Ci != Co
        ("fused_conv3x3_relu_pool2", (2, 20, 26), 512, 512),  # 8 64-channel chunks of K and of N
    ):
        kernel, plain = CONV_KERNELS[name]
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = conv_case(sum(shape) + cin, shape, cin, cout, dtype)
            rounded = dtype == torch.bfloat16 or kernel is kernels.fused_stem_conv_relu_pool2
            err = conv_err(f"{name} {list(shape) + [cin]} -> {cout} {dtype}", kernel(x, w, b), plain(x, w, b), rounded)
            errs[name] = max(errs.get(name, 0.0), err)

    w1, b1, w2, b2 = block1_weights
    g = torch.Generator().manual_seed(0)
    worst = 0.0
    for shape in ((BATCH, 320, 320), (3, 36, 52)):
        # whitened-pixel scale: VGG-mean-subtracted values in about +-150
        x = (torch.rand(*shape, 3, generator=g) * 255 - 120).to(torch.bfloat16).cuda()
        got = kernels.fused_vgg_block1(x, w1, b1, w2, b2)
        ref = kernels.fused_vgg_block1_plain(x, w1, b1, w2, b2)
        worst = max(worst, block1_err(str(list(shape) + [3]), got, ref))
    errs["fused_vgg_block1"] = worst
    return errs


def f32_parity(state, images, flags):
    """Phase 4a: float32 against the reference detections: the Detector as
    it runs (fixpoint NMS), then its candidates through the scan NMS.
    Returns the Detector's detections."""
    model = RON(RON_320_SPEC, dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    det = Detector(model, RON_320_SPEC, NMS_CFG, device="cuda")
    dets = det(images)
    check_detections(f"{flags}, fixpoint NMS (the Detector's)", *dets)
    with torch.inference_mode():
        flat_s, flat_b = det.candidates(det.model(images))
        scan_s, scan_b = nms_sorted_kernel(flat_s, flat_b, NMS_CFG.nms_threshold, NMS_CFG.keep_top_k,
                                           NMS_CFG.nms_mode, method="scan")
    c = RON_320_SPEC.num_classes - 1
    check_detections(f"{flags}, scan NMS", scan_s.reshape(len(images), c, -1),
                     scan_b.reshape(len(images), c, -1, 4))
    return dets


def bf16_drift(state, images, f32_dets):
    """Phase 4b: how far the bf16 detections of the four images lie from the
    f32 ones, with block 1 unfused (cuDNN) and through K-B: the (image,
    class) pairs whose keep counts agree, the detections on each side, and
    over the pairs that agree the largest score and box difference."""
    ref_s, ref_b = (t.float() for t in f32_dets)
    drift = {}
    for fuse in (False, True):
        model = RON(RON_320_SPEC, dtype=torch.bfloat16, fuse_block1=fuse)
        model.load_state_dict(state, strict=True)
        kernels.reset_launch_counts()
        got_s, got_b = Detector(model, RON_320_SPEC, NMS_CFG, device="cuda")(images)
        torch.cuda.synchronize()
        if kernels.fused_vgg_block1.launches != int(fuse):
            raise AssertionError("the bf16 drift run did not take the intended block 1")
        n_ref, n_got = (ref_s > 0).sum(-1), (got_s > 0).sum(-1)
        same = n_ref == n_got
        rank = torch.arange(ref_s.shape[-1], device=ref_s.device)
        live = same[..., None] & (rank < n_ref[..., None])
        d_s = float(torch.where(live, (got_s - ref_s).abs(), 0.0).max())
        d_b = float(torch.where(live[..., None], (got_b - ref_b).abs(), 0.0).max())
        label = "K-B" if fuse else "unfused (cuDNN)"
        drift[label] = {"pairs_equal_counts": int(same.sum()), "pairs": same.numel(),
                        "detections_bf16": int(n_got.sum()), "detections_f32": int(n_ref.sum()),
                        "sum_abs_count_diff": int((n_got - n_ref).abs().sum()),
                        "max_abs_score_diff": d_s, "max_abs_box_diff": d_b}
        print(f"  bf16 vs f32 detections, block 1 {label}: keep counts equal in {int(same.sum())} of "
              f"{same.numel()} (image, class) pairs; {int(n_got.sum())} detections vs {int(n_ref.sum())}; "
              f"over the equal pairs max |score diff| {d_s:.6g}, max |box diff| {d_b:.6g}")
    return drift


def check_detections(label, scores, boxes):
    """Detections [B, C-1, keep_top_k(, 4)] of the demo images against the
    fixture's reference: equal keep counts and labels, scores and boxes
    within PARITY_ATOL."""
    scores, boxes = scores.cpu().numpy(), boxes.cpu().numpy()
    fx = np.load(TRAINED_FIXTURE, allow_pickle=False)
    worst, n_kept = 0.0, 0
    for i, img in enumerate(IMAGES):
        for cls in range(1, RON_320_SPEC.num_classes):
            ref_s = fx[f"img_{img}_stream_c{cls}_scores"][0]
            ref_b = fx[f"img_{img}_stream_c{cls}_boxes"][0]
            ref_n = int((ref_s > 0).sum())
            got_n = int((scores[i, cls - 1] > 0).sum())
            if got_n != ref_n:
                raise AssertionError(f"image {img} class {cls}: kept {got_n} vs reference {ref_n}")
            np.testing.assert_allclose(scores[i, cls - 1, :ref_n], ref_s[:ref_n], atol=PARITY_ATOL, rtol=0)
            np.testing.assert_allclose(boxes[i, cls - 1, :ref_n], ref_b[:ref_n], atol=PARITY_ATOL, rtol=0)
            if ref_n:
                worst = max(worst, float(np.abs(scores[i, cls - 1, :ref_n] - ref_s[:ref_n]).max()),
                            float(np.abs(boxes[i, cls - 1, :ref_n] - ref_b[:ref_n]).max()))
            n_kept += ref_n
    print(f"  f32 ({label}): {n_kept} detections over {len(IMAGES)} images x 20 classes equal the reference "
          f"(keep counts, labels); max |diff| of scores and boxes {worst:.3g} <= {PARITY_ATOL}")


MAIN_PATH = ("nms_fixpoint_keep_mask", "fused_vgg_block1")
API_PATH = ("nms_scan_keep_mask", "fused_stem_conv_relu_pool2", "fused_conv3x3_relu_pool2")


def check_counts(label, launches, on_path):
    """Every kernel of the path launched, and no other."""
    print(f"  launches on the {label}: {launches}")
    missing = [n for n in on_path if launches[n] < 1]
    stray = [n for n in launches if n not in on_path and launches[n]]
    if missing or stray:
        raise AssertionError(f"{label}: never launched {missing}; launched off the path {stray}")


def nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()


def api_path(model, det, batch, block1, max_err):
    """Phase 5: the kernels API on the main path's own data. Its inputs are
    made first (the backbone runs K-B); the counts are reset just before
    the four calls and read just after. Returns the inputs, for timing."""
    thr, mode, cap = NMS_CFG.nms_threshold, NMS_CFG.nms_mode, NMS_CFG.keep_top_k
    w1, b1, w2, b2 = block1
    bb = model.backbone
    with torch.inference_mode():
        flat_s, flat_b = (t.contiguous() for t in det.candidates(det.model(batch)))
        x = batch.to(torch.bfloat16)
        # relu(conv1_1) rounded to bf16, as K-B's plain version computes it
        y1 = nhwc(F.relu(F.conv2d(x.float().permute(0, 3, 1, 2), w1.to(torch.bfloat16).float(), b1.float(),
                                  padding=1)).to(torch.bfloat16))
        a21 = bb.conv2_1(bb._block1(x.permute(0, 3, 1, 2)))  # VGG block-2 tail's input
        a32 = bb.conv3_2(bb.conv3_1(max_pool_2x2(bb.conv2_2(a21))))  # block-3 tail's input
        tails = {"block2": (nhwc(a21), bb.conv2_2.conv), "block3": (nhwc(a32), bb.conv3_3.conv)}
        block1_out = kernels.fused_vgg_block1(x.contiguous(), w1, b1, w2, b2)
        torch.cuda.synchronize()

        kernels.reset_launch_counts()
        scan_s, scan_b = nms_sorted_kernel(flat_s, flat_b, thr, cap, mode, method="scan")
        stem_out = kernels.fused_stem_conv_relu_pool2(y1, w2, b2)
        tail_out = {k: kernels.fused_conv3x3_relu_pool2(a, c.weight, c.bias) for k, (a, c) in tails.items()}
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    check_counts("kernels API path", launches, API_PATH)

    with torch.inference_mode():
        keep = kernels.nms_scan_keep_mask(flat_s, flat_b, thr, cap, mode)
        keep_plain = kernels.nms_scan_keep_mask_plain(flat_s, flat_b, thr, cap, mode)
        err, n_diff = mask_err(keep, keep_plain)
        ref_s, ref_b = compact_keep(keep_plain, flat_s, flat_b, cap)
        if n_diff or not (torch.equal(scan_s, ref_s) and torch.equal(scan_b, ref_b)):
            raise AssertionError(f"scan NMS on the main path's candidates: {n_diff} mask differences")
        max_err["nms_scan_keep_mask"] = max(max_err["nms_scan_keep_mask"], err)
        print(f"  nms_scan_keep_mask on the main path's candidates {list(flat_s.shape)}, keep_top_k {cap}: "
              f"0 mask differences, {int(keep_plain.sum())} kept; detections equal the plain mask's")
        name = "fused_stem_conv_relu_pool2"
        max_err[name] = max(max_err[name], conv_err(
            f"{name} relu(conv1_1) {list(y1.shape)} -> 64 vs plain", stem_out,
            kernels.fused_stem_conv_relu_pool2_plain(y1, w2, b2), rounded=True))
        # K-B rounds conv1_1 to bf16 as y1 is: the same function, one bf16 ulp apart at most
        conv_err(f"{name} vs fused_vgg_block1 on the batch", stem_out, block1_out, rounded=True, f32_tol=0.0)
        name = "fused_conv3x3_relu_pool2"
        for k, (a, c) in tails.items():
            max_err[name] = max(max_err[name], conv_err(
                f"{name} {k} tail {list(a.shape)} -> {c.out_channels} vs plain", tail_out[k],
                kernels.fused_conv3x3_relu_pool2_plain(a, c.weight, c.bias), rounded=True))
    return launches, (flat_s, flat_b, keep_plain), y1, tails


def block1_grads(x, block1):
    """Phase 6: K-B's gradients (kernel forward, recompute backward) against
    autograd through `block1_reference`, for one random output gradient."""
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, w, _ = x.shape
    go = torch.randn(b, h // 2, w // 2, 64, generator=g, device="cuda").to(x.dtype)
    grads = {}
    for fn in (kernels.fused_vgg_block1, block1_reference):
        leaves = [t.detach().clone().requires_grad_() for t in (x, *block1)]
        kernels.reset_launch_counts()
        fn(*leaves).backward(go)
        torch.cuda.synchronize()
        if kernels.fused_vgg_block1.launches != (fn is kernels.fused_vgg_block1):
            raise AssertionError("the gradient run did not go through the block-1 kernel")
        grads[fn.__name__] = [t.grad for t in leaves]
    for name, got, ref in zip(("x", "w1", "b1", "w2", "b2"), *grads.values()):
        if got is None or not torch.isfinite(got).all():
            raise AssertionError(f"d{name}: no finite gradient through the kernel path")
        scale = float(ref.float().abs().max())
        err = float((got.float() - ref.float()).abs().max())
        print(f"  d{name} {list(got.shape)} {got.dtype}: max |kernel path - composition| = {err:.6g}, "
              f"{err / scale:.3g} of max |grad| {scale:.6g} (tolerance {GRAD_REL_TOL})")
        if err > GRAD_REL_TOL * scale:
            raise AssertionError(f"d{name} differs from the composition's")


def conv_row(name, calls, max_err, launches, replaces):
    """One kernels-line row for K-D or K-E: times summed over the calls
    {label: (x, weight, bias)} of its path, and each call's own under
    "parts"."""
    kernel, plain = CONV_KERNELS[name]
    parts = {}
    for label, (x, w, b) in calls.items():
        bsz, h, wd, cin = x.shape
        cout = w.shape[0]
        flops = 2 * bsz * h * wd * cin * cout * 9
        nbytes = x.numel() * 2 + bsz * (h // 2) * (wd // 2) * cout * 2 + w.numel() * 2 + cout * 4
        xn, wl, bl = x.permute(0, 3, 1, 2), w.to(torch.bfloat16), b.to(torch.bfloat16)
        bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        parts[label] = with_rates({
            "ms": cuda_ms(lambda: kernel(x, w, b), reps=20),
            "plain_ms": cuda_ms(lambda: plain(x, w, b), reps=2),
            "library_ms": cuda_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xn, wl, bl, padding=1)), 2, 2), reps=20),
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        }, flops)
    total = {k: sum(p[k] for p in parts.values()) for k in ("ms", "plain_ms", "library_ms", "flops", "bytes")}
    bound_ms, bound_by = bound(total["bytes"], total["flops"], PEAK_BF16_FLOPS)
    row = with_rates({
        "name": name, "route": "cuda", "source": "ron_tensorflow_tpu_torch/csrc/conv3x3_relu_pool2.cu",
        "replaces": replaces, "path": "kernels API", "launches": launches[name], "max_abs_err": max_err[name],
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": total["library_ms"],
    }, total["flops"])
    if len(parts) > 1:
        row["parts"] = parts
    return row


def with_rates(row, flops):
    """A conv kernel's row with its achieved TFLOP/s, its share of the bound
    (bound_ms / ms) and its time over the library call's."""
    row["tflops"] = flops / row["ms"] * 1e-9
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["library_ratio"] = row["ms"] / row["library_ms"]
    return row


def profile_detector(det, batch):
    """One torch.profiler pass over a bf16 batch-32 Detector call: the top
    device kernels by time, and the share of the call's wall time in which
    a kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        det(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            det(batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    # the device's own events (kernels, copies), not the host ops that launched them
    kernels_run = (e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    events = sorted((e for e in kernels_run if device_us(e) > 0), key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in events)
    if not events:
        print("  the profiler trace holds no device time")
        return {"device_us": 0.0, "wall_us": wall_us, "top": []}
    top = [{"name": e.key[:120], "device_us": device_us(e), "count": e.count} for e in events[:12]]
    print(f"  profiled Detector batch: {busy_us / 1e3:.3f} ms of kernels in {wall_us / 1e3:.3f} ms wall "
          f"(device busy {busy_us / wall_us:.3f}, host clock, profiler on); top kernels:")
    for t in top:
        print(f"    {t['device_us'] / 1e3:8.3f} ms  x{t['count']:<4} {t['name']}")
    return {"device_us": busy_us, "wall_us": wall_us, "top": top}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.device_count()} device(s)")

    with phase("build"):
        seconds = _build.timed_build()
        print(f"  one nvcc call: {_build.library_path().name} in {seconds:.2f} s")
        tc_report = tensor_core_report()
        for name, info in sorted(_build.ptxas_report().items()):
            if "nms_sweep_kernel" in name:
                print(f"  {name}: {info.get('registers')} registers, {info.get('spill_stores')} bytes spill "
                      f"stores, {info.get('spill_loads')} bytes spill loads")

    with phase("weights"):
        state = from_jax_params(*load_trained_fixture(str(TRAINED_FIXTURE)))
        fx = np.load(TRAINED_FIXTURE, allow_pickle=False)
        pixels = [torch.as_tensor(fx[f"img_{i}_pixels"], device="cuda") for i in IMAGES]
        images = torch.stack([eval_preprocess(p.float() / 255.0, RON_320_SPEC.img_shape)[0] for p in pixels])
        block1 = tuple(state[f"backbone.conv1_{j}.conv.{p}"].cuda() for j in (1, 2) for p in ("weight", "bias"))

    with phase("kernels"):
        max_err = check_kernels(block1)

    with phase("main f32"):
        f32_dets = f32_parity(state, images, "TF32 off")
        with torch_default_flags():
            f32_parity(state, images, "torch's default flags, cuDNN TF32 on")

    with phase("bf16 drift"):
        drift = bf16_drift(state, images, f32_dets)

    with phase("main bf16"):
        model = RON(RON_320_SPEC, dtype=torch.bfloat16, fuse_block1=True)
        model.load_state_dict(state, strict=True)
        det = Detector(model, RON_320_SPEC, NMS_CFG, device="cuda")
        batch = images.repeat(BATCH // len(IMAGES), 1, 1, 1).contiguous()
        kernels.reset_launch_counts()
        scores, boxes = det(batch)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        check_counts("main path", launches, MAIN_PATH)
        c = RON_320_SPEC.num_classes - 1
        if scores.shape != (BATCH, c, NMS_CFG.keep_top_k) or boxes.shape != (BATCH, c, NMS_CFG.keep_top_k, 4):
            raise AssertionError(f"bad output shapes {tuple(scores.shape)}, {tuple(boxes.shape)}")
        if not (torch.isfinite(scores).all() and torch.isfinite(boxes).all()):
            raise AssertionError("non-finite detections")
        kept = (scores > 0).sum(dim=(1, 2))
        print(f"  bf16 batch {BATCH}: detections per image {kept[:len(IMAGES)].tolist()} (first images)")
        if int(kept.min()) < 1:
            raise AssertionError("an image kept no detection")

    with phase("api"):
        api_launches, (flat_s, flat_b, scan_keep), y1, tails = api_path(model, det, batch, block1, max_err)

    with phase("grad"):
        block1_grads(batch.to(torch.bfloat16).contiguous(), block1)

    with phase("timing"):
        print(f"  card before timing: {smi_sample()} (SM clock, power, temperature)")
        with torch.inference_mode():
            ms_det = cuda_ms(lambda: det(batch), reps=5, warmup=2)
            out = det.model(batch)
            nhwc_batch = batch.to(torch.bfloat16).contiguous()
            # where the Detector's time goes, stage by stage (CUDA events)
            breakdown = {
                "forward": cuda_ms(lambda: det.model(batch), reps=5),
                "candidates": cuda_ms(lambda: det.candidates(out), reps=5),
                "nms": cuda_ms(lambda: nms_sorted_kernel(
                    flat_s, flat_b, NMS_CFG.nms_threshold, NMS_CFG.keep_top_k, NMS_CFG.nms_mode), reps=20),
            }
            print(f"  card after the stage split: {smi_sample()}")
            # the per-class top-k as the Detector runs it (chunked) against one
            # stable sort of each whole row, on the main path's scores
            cls_scores, _ = det.class_scores(out)
            k_top = NMS_CFG.top_k
            chunked = exact_top_k_chunked(cls_scores, k_top, TOPK_CHUNKS)
            one_sort = [t[..., :k_top] for t in torch.sort(cls_scores, dim=-1, descending=True, stable=True)]
            if not all(torch.equal(a, b) for a, b in zip(chunked, one_sort)):
                raise AssertionError("chunked top-k differs from one stable sort")
            topk_ms = {
                "chunked": cuda_ms(lambda: exact_top_k_chunked(cls_scores, k_top, TOPK_CHUNKS), reps=20),
                "one_sort": cuda_ms(lambda: torch.sort(cls_scores, dim=-1, descending=True, stable=True), reps=20),
            }
            print(f"  Detector bf16 batch {BATCH}: {ms_det:.3f} ms/batch, {BATCH * 1e3 / ms_det:.1f} img/s; "
                  f"stages (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()))
            print(f"  top-k of {list(cls_scores.shape)}, k={k_top}: {TOPK_CHUNKS} chunks {topk_ms['chunked']:.4f} ms, "
                  f"one stable sort {topk_ms['one_sort']:.4f} ms")
            results = timing_rows(launches, api_launches, max_err, block1, nhwc_batch,
                                  flat_s, flat_b, scan_keep, y1, tails)
            nms_split = nms_stage_split(breakdown["nms"], results[0]["ms"], flat_s, flat_b)
        for res in results:
            res.update(tc_report.get(res["name"], {}))
            rates = (f", {res['tflops']:.1f} TFLOP/s, {res['bound_share']:.3f} of bound, "
                     f"{res['library_ratio']:.3f}x the library" if "tflops" in res else "")
            nms = (f"; device time, {res['call_ms']:.4f} ms a wrapper call; kept per row mean "
                   f"{res['kept_mean']:.2f}, max {res['kept_max']}" if "call_ms" in res else "")
            print(f"  {res['name']}: {res['ms']:.4f} ms (plain {res['plain_ms']:.4f}, bound {res['bound_ms']:.4f} "
                  f"by {res['bound_by']}, library {res['library_ms']}{rates}{nms})")
            for label, p in res.get("parts", {}).items():
                print(f"    {label} tail: {p['ms']:.4f} ms (plain {p['plain_ms']:.4f}, bound {p['bound_ms']:.4f} "
                      f"by {p['bound_by']}, library {p['library_ms']:.4f}), {p['tflops']:.1f} TFLOP/s, "
                      f"{p['bound_share']:.3f} of bound, {p['library_ratio']:.3f}x the library")
        print(f"  card after timing: {smi_sample()}")

    with phase("profile"):
        profile = profile_detector(det, batch)

    print(json.dumps({"kernels": results, "detector_bf16_b32_img_per_s": BATCH * 1e3 / ms_det,
                      "detector_stage_ms": breakdown, "nms_stage_split": nms_split, "topk_ms": topk_ms,
                      "bf16_vs_f32": drift, "profile": profile}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def greedy_pairs(keep):
    """Overlaps a greedy keep set needs: each kept i against every later j."""
    k = keep.shape[-1]
    return int((keep * torch.arange(k - 1, -1, -1, device=keep.device)).sum())


def kept_stats(keep):
    per_row = keep.sum(-1).float()
    return {"kept_mean": float(per_row.mean()), "kept_max": int(per_row.max())}


def nms_times(fn):
    """An NMS kernel's device time (torch.profiler, the kernel's own device
    events, per launch) as "ms", and the wrapper's per-call time (CUDA
    events around back-to-back calls: host cost included) as "call_ms"."""
    ms, seen = device_ms(fn)
    return {"ms": ms, "call_ms": cuda_ms(fn, reps=50), "device_launches_traced": seen}


def nms_stage_split(stage_ms, mask_device_ms, flat_s, flat_b):
    """The Detector's NMS stage (`nms_sorted_kernel`: K-A's mask, then
    `compact_keep`) split into K-A's device time, compact_keep's device
    time and launches, and what is left: host time the device waits for."""
    thr, mode, cap = NMS_CFG.nms_threshold, NMS_CFG.nms_mode, NMS_CFG.keep_top_k
    keep = kernels.nms_fixpoint_keep_mask(flat_s, flat_b, thr, mode)
    compact = lambda: compact_keep(keep, flat_s, flat_b, cap)  # noqa: E731
    reps = 50
    compact_dev, compact_events = device_ms(compact, reps=reps, match="")
    split = {"stage_ms": stage_ms, "keep_mask_device_ms": mask_device_ms,
             "compact_device_ms": compact_dev, "compact_launches": compact_events / reps,
             "compact_call_ms": cuda_ms(compact, reps=reps)}
    split["rest_ms"] = stage_ms - mask_device_ms - compact_dev
    print(f"  NMS stage {stage_ms:.4f} ms = K-A {mask_device_ms:.4f} ms (device) + compact_keep "
          f"{compact_dev:.4f} ms (device, {split['compact_launches']:.0f} launches; "
          f"{split['compact_call_ms']:.4f} ms a call) + {split['rest_ms']:.4f} ms of host time the card waits for")
    return split


def timing_rows(launches, api_launches, max_err, block1, nhwc_batch, flat_s, flat_b, scan_keep, y1, tails):
    """Phase 7: one row per kernel, each timed on its path's own inputs."""
    results = []
    thr, mode, cap = NMS_CFG.nms_threshold, NMS_CFG.nms_mode, NMS_CFG.keep_top_k
    r, k = flat_s.shape
    # the kernels once more against their plain versions, on the main path's own inputs
    keep = kernels.nms_fixpoint_keep_mask(flat_s, flat_b, thr, mode)
    keep_plain = kernels.nms_fixpoint_keep_mask_plain(flat_s, flat_b, thr, mode)
    err, n_diff = mask_err(keep, keep_plain)
    max_err["nms_fixpoint_keep_mask"] = max(max_err["nms_fixpoint_keep_mask"], err)
    if n_diff:
        raise AssertionError(f"NMS keep masks differ on the main path's candidates ({n_diff} entries)")
    w1, b1, w2, b2 = block1
    max_err["fused_vgg_block1"] = max(max_err["fused_vgg_block1"], block1_err(
        "main path's batch", kernels.fused_vgg_block1(nhwc_batch, w1, b1, w2, b2),
        kernels.fused_vgg_block1_plain(nhwc_batch, w1, b1, w2, b2)))
    # K-A's bound counts the work these rows need, as K-C's does: each kept i
    # against every later j. The fixpoint algorithm's all-pairs count is
    # printed beside it, for the record.
    _, steps = fixpoint_keep(flat_s > 0, suppression_matrix(flat_b, thr, mode))
    nms_bytes = r * k * (4 + 16 + 1)
    nms_bound, nms_by = bound(nms_bytes, 12 * greedy_pairs(keep), PEAK_F32_FLOPS)
    fixpoint_ops = r * k * (k - 1) / 2 * 11 + steps * r * k * ((k + 31) // 32) * 2
    old_bound, old_by = bound(nms_bytes, fixpoint_ops, PEAK_F32_FLOPS)
    fn = lambda: kernels.nms_fixpoint_keep_mask(flat_s, flat_b, thr, mode)  # noqa: E731
    results.append({
        "name": "nms_fixpoint_keep_mask", "route": "cuda", "source": NMS_SOURCE,
        "replaces": "ron_tensorflow_tpu/kernels/nms_pallas.py:225", "path": "main",
        "launches": launches["nms_fixpoint_keep_mask"],
        "max_abs_err": max_err["nms_fixpoint_keep_mask"],
        **nms_times(fn),
        "plain_ms": cuda_ms(lambda: kernels.nms_fixpoint_keep_mask_plain(flat_s, flat_b, thr, mode), reps=3),
        "bound_ms": nms_bound, "bound_by": nms_by, "library_ms": None, **kept_stats(keep),
    })
    print(f"  nms rows [{r},{k}]: {int(keep.sum())} kept, {greedy_pairs(keep)} overlaps needed; "
          f"the fixpoint algorithm's count ({steps} steps, all pairs) would make the bound "
          f"{old_bound:.4f} ms by {old_by}; block 1 on the batch: max |kernel - plain| = "
          f"{max_err['fused_vgg_block1']:.6g}")

    bsz, h, w, _ = nhwc_batch.shape
    blk_flops = 2 * bsz * h * w * 64 * 9 * (3 + 64)
    blk_bytes = nhwc_batch.numel() * 2 + bsz * (h // 2) * (w // 2) * 64 * 2 + (w1.numel() + w2.numel()) * 2 + 128 * 4
    blk_bound, blk_by = bound(blk_bytes, blk_flops, PEAK_BF16_FLOPS)
    x_nchw = nhwc_batch.permute(0, 3, 1, 2)  # channels_last view, no copy
    lw1, lb1, lw2, lb2 = (t.to(torch.bfloat16) for t in block1)

    def library_block1():
        y = F.relu(F.conv2d(x_nchw, lw1, lb1, padding=1))
        return F.max_pool2d(F.relu(F.conv2d(y, lw2, lb2, padding=1)), 2, 2)

    results.append(with_rates({
        "name": "fused_vgg_block1", "route": "cuda",
        "source": "ron_tensorflow_tpu_torch/csrc/fused_vgg_block1.cu",
        "replaces": "ron_tensorflow_tpu/kernels/fused_conv_pool.py:388", "path": "main",
        "launches": launches["fused_vgg_block1"],
        "max_abs_err": max_err["fused_vgg_block1"],
        "ms": cuda_ms(lambda: kernels.fused_vgg_block1(nhwc_batch, w1, b1, w2, b2), reps=20),
        "plain_ms": cuda_ms(lambda: kernels.fused_vgg_block1_plain(nhwc_batch, w1, b1, w2, b2), reps=3),
        "bound_ms": blk_bound, "bound_by": blk_by,
        "library_ms": cuda_ms(library_block1, reps=20),
    }, blk_flops))

    # K-C: the pairs this run's keep set needs, each kept i against every later j
    pairs = greedy_pairs(scan_keep)
    scan_bound, scan_by = bound(r * k * (4 + 16 + 1), 12 * pairs, PEAK_F32_FLOPS)
    fn = lambda: kernels.nms_scan_keep_mask(flat_s, flat_b, thr, cap, mode)  # noqa: E731
    results.append({
        "name": "nms_scan_keep_mask", "route": "cuda", "source": NMS_SOURCE,
        "replaces": "ron_tensorflow_tpu/kernels/nms_pallas.py:93", "path": "kernels API",
        "launches": api_launches["nms_scan_keep_mask"], "max_abs_err": max_err["nms_scan_keep_mask"],
        **nms_times(fn),
        "plain_ms": cuda_ms(lambda: kernels.nms_scan_keep_mask_plain(flat_s, flat_b, thr, cap, mode), reps=2),
        "bound_ms": scan_bound, "bound_by": scan_by, "library_ms": None, **kept_stats(scan_keep),
    })
    print(f"  scan rows [{r},{k}], keep_top_k {cap}: {int(scan_keep.sum())} kept, {pairs} overlaps needed")

    results.append(conv_row("fused_stem_conv_relu_pool2", {"block1": (y1, w2, b2)}, max_err, api_launches,
                            "ron_tensorflow_tpu/kernels/fused_conv_pool.py:116"))
    results.append(conv_row("fused_conv3x3_relu_pool2", {k: (a, c.weight, c.bias) for k, (a, c) in tails.items()},
                            max_err, api_launches, "ron_tensorflow_tpu/kernels/fused_conv_pool.py:470"))
    return results


if __name__ == "__main__":
    sys.exit(main())
