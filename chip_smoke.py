"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each ending with a line that gives its elapsed seconds:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    the port's CUDA kernels, one nvcc call;
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes (and a few edge shapes);
  4. main     full-width RON-320 with the trained weights packed in
              tests/fixtures/e2e_parity_trained.npz, pixels to boxes:
              (a) float32, TF32 off, against the fixture's reference
              detections; (b) bf16, batch 32, fused block 1, through both
              kernels (launch counts read around this run);
  5. timing   the bf16 batch-32 Detector's images/s, and each kernel's time
              beside its plain version's, its bound and a library yardstick.
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
from ron_tensorflow_tpu_torch.kernels.nms import fixpoint_keep, nms_sorted_kernel, suppression_matrix
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC
from ron_tensorflow_tpu_torch.ops.math import exact_top_k_chunked
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


def check_kernels(block1_weights):
    """Phase 3: every kernel against its plain version on the card."""
    errs = {"nms_fixpoint_keep_mask": 0.0}
    for label, (r, k, grid, thr) in {
        "main-path shape": (BATCH * 20, NMS_CFG.top_k, None, NMS_CFG.nms_threshold),
        "exact-threshold grid": (64, NMS_CFG.top_k, 8, 0.5),
        "K=1024": (8, 1024, 4, 0.25),
    }.items():
        for mode in ("min", "union"):
            scores, boxes = sorted_rows(r + k, r, k, grid)
            got = kernels.nms_fixpoint_keep_mask(scores, boxes, thr, mode)
            ref = kernels.nms_fixpoint_keep_mask_plain(scores, boxes, thr, mode)
            torch.cuda.synchronize()
            err, n_diff = mask_err(got, ref)
            errs["nms_fixpoint_keep_mask"] = max(errs["nms_fixpoint_keep_mask"], err)
            print(f"  nms_fixpoint_keep_mask {label} [{r},{k}] {mode}: {n_diff} mask differences, "
                  f"{int(ref.sum())} kept")
            if n_diff:
                raise AssertionError(f"NMS keep masks differ ({label}, {mode})")

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


def f32_parity(state, images):
    """Phase 4a: float32, TF32 off, against the reference detections."""
    model = RON(RON_320_SPEC, dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    det = Detector(model, RON_320_SPEC, NMS_CFG, device="cuda")
    scores, boxes = (t.cpu().numpy() for t in det(images))
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
    print(f"  f32: {n_kept} detections over {len(IMAGES)} images x 20 classes equal the reference "
          f"(keep counts, labels); max |diff| of scores and boxes {worst:.3g} <= {PARITY_ATOL}")
    del det, model


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

    with phase("weights"):
        state = from_jax_params(*load_trained_fixture(str(TRAINED_FIXTURE)))
        fx = np.load(TRAINED_FIXTURE, allow_pickle=False)
        pixels = [torch.as_tensor(fx[f"img_{i}_pixels"], device="cuda") for i in IMAGES]
        images = torch.stack([eval_preprocess(p.float() / 255.0, RON_320_SPEC.img_shape)[0] for p in pixels])
        block1 = tuple(state[f"backbone.conv1_{j}.conv.{p}"].cuda() for j in (1, 2) for p in ("weight", "bias"))

    with phase("kernels"):
        max_err = check_kernels(block1)

    with phase("main f32"):
        f32_parity(state, images)

    with phase("main bf16"):
        model = RON(RON_320_SPEC, dtype=torch.bfloat16, fuse_block1=True)
        model.load_state_dict(state, strict=True)
        det = Detector(model, RON_320_SPEC, NMS_CFG, device="cuda")
        batch = images.repeat(BATCH // len(IMAGES), 1, 1, 1).contiguous()
        kernels.reset_launch_counts()
        scores, boxes = det(batch)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        print(f"  launches on the main path: {launches}")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the main path never launched: {launches}")
        c = RON_320_SPEC.num_classes - 1
        if scores.shape != (BATCH, c, NMS_CFG.keep_top_k) or boxes.shape != (BATCH, c, NMS_CFG.keep_top_k, 4):
            raise AssertionError(f"bad output shapes {tuple(scores.shape)}, {tuple(boxes.shape)}")
        if not (torch.isfinite(scores).all() and torch.isfinite(boxes).all()):
            raise AssertionError("non-finite detections")
        kept = (scores > 0).sum(dim=(1, 2))
        print(f"  bf16 batch {BATCH}: detections per image {kept[:len(IMAGES)].tolist()} (first images)")
        if int(kept.min()) < 1:
            raise AssertionError("an image kept no detection")

    with phase("timing"):
        with torch.inference_mode():
            ms_det = cuda_ms(lambda: det(batch), reps=5, warmup=2)
            out = det.model(batch)
            flat_s, flat_b = (t.contiguous() for t in det.candidates(out))
            nhwc = batch.to(torch.bfloat16).contiguous()
            # where the Detector's time goes, stage by stage (CUDA events)
            breakdown = {
                "forward": cuda_ms(lambda: det.model(batch), reps=5),
                "candidates": cuda_ms(lambda: det.candidates(out), reps=5),
                "nms": cuda_ms(lambda: nms_sorted_kernel(
                    flat_s, flat_b, NMS_CFG.nms_threshold, NMS_CFG.keep_top_k, NMS_CFG.nms_mode), reps=20),
            }
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
        results = []

        thr, mode = NMS_CFG.nms_threshold, NMS_CFG.nms_mode
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
            "main path's batch", kernels.fused_vgg_block1(nhwc, w1, b1, w2, b2),
            kernels.fused_vgg_block1_plain(nhwc, w1, b1, w2, b2)))
        # fixpoint steps on these rows: the data-dependent part of K-A's work
        _, steps = fixpoint_keep(flat_s > 0, suppression_matrix(flat_b, thr, mode))
        words = (k + 31) // 32
        nms_bytes = r * k * (4 + 16 + 1)
        nms_ops = r * k * (k - 1) / 2 * 11 + steps * r * k * words * 2
        nms_bound, nms_by = bound(nms_bytes, nms_ops, PEAK_F32_FLOPS)
        results.append({
            "name": "nms_fixpoint_keep_mask", "route": "cuda",
            "source": "ron_tensorflow_tpu_torch/csrc/nms_fixpoint.cu",
            "replaces": "ron_tensorflow_tpu/kernels/nms_pallas.py:225",
            "launches": launches["nms_fixpoint_keep_mask"],
            "max_abs_err": max_err["nms_fixpoint_keep_mask"],
            "ms": cuda_ms(lambda: kernels.nms_fixpoint_keep_mask(flat_s, flat_b, thr, mode), reps=50),
            "plain_ms": cuda_ms(lambda: kernels.nms_fixpoint_keep_mask_plain(flat_s, flat_b, thr, mode), reps=3),
            "bound_ms": nms_bound, "bound_by": nms_by, "library_ms": None,
        })
        print(f"  nms rows [{r},{k}]: {steps} fixpoint steps, {int(keep.sum())} kept; "
              f"block 1 on the batch: max |kernel - plain| = {max_err['fused_vgg_block1']:.6g}")

        bsz, h, w, _ = nhwc.shape
        blk_flops = 2 * bsz * h * w * 64 * 9 * (3 + 64)
        blk_bytes = nhwc.numel() * 2 + bsz * (h // 2) * (w // 2) * 64 * 2 + (w1.numel() + w2.numel()) * 2 + 128 * 4
        blk_bound, blk_by = bound(blk_bytes, blk_flops, PEAK_BF16_FLOPS)
        x_nchw = nhwc.permute(0, 3, 1, 2)  # channels_last view, no copy
        lw1, lb1, lw2, lb2 = (t.to(torch.bfloat16) for t in block1)

        def library_block1():
            y = F.relu(F.conv2d(x_nchw, lw1, lb1, padding=1))
            return F.max_pool2d(F.relu(F.conv2d(y, lw2, lb2, padding=1)), 2, 2)

        results.append({
            "name": "fused_vgg_block1", "route": "cuda",
            "source": "ron_tensorflow_tpu_torch/csrc/fused_vgg_block1.cu",
            "replaces": "ron_tensorflow_tpu/kernels/fused_conv_pool.py:388",
            "launches": launches["fused_vgg_block1"],
            "max_abs_err": max_err["fused_vgg_block1"],
            "ms": cuda_ms(lambda: kernels.fused_vgg_block1(nhwc, w1, b1, w2, b2), reps=5),
            "plain_ms": cuda_ms(lambda: kernels.fused_vgg_block1_plain(nhwc, w1, b1, w2, b2), reps=3),
            "bound_ms": blk_bound, "bound_by": blk_by,
            "library_ms": cuda_ms(library_block1, reps=5),
        })
        for res in results:
            print(f"  {res['name']}: {res['ms']:.4f} ms (plain {res['plain_ms']:.4f}, bound {res['bound_ms']:.4f} "
                  f"by {res['bound_by']}, library {res['library_ms']})")

    print(json.dumps({"kernels": results, "detector_bf16_b32_img_per_s": BATCH * 1e3 / ms_det,
                      "detector_stage_ms": breakdown, "topk_ms": topk_ms}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
