"""Time the NMS keep-mask kernels K-A and K-C of one copy of the port on the card.

    python3 ron_tensorflow_tpu_torch/tools/time_nms.py [ROOT]

ROOT (default: the checkout that holds this script) is the directory whose
`ron_tensorflow_tpu_torch` package is timed, for example a `git archive` of
another commit unpacked under the gitignored `_checkouts/`. To compare two
versions, run the script once per copy, in turns (A, B, B, A), in one call
on the card.

The rows are the main path's own: the NMS candidates ([640, 200]) of the
bf16 RON-320 Detector (fused block 1) on the trained fixture's four images
tiled to batch 32. The first run computes them with ROOT's package and
keeps them in this checkout's `ron_tensorflow_tpu_torch/_build/`, so every
later run, of any copy, times the same rows. Beside them, random rows at
K = 2048 ([32, 2048], the realtime head's top_k) where ROOT's kernels take
that K. And, to split a kernel's time into a fixed part and a cost per
step, rows [640, 200] of disjoint boxes whose first n scores are > 0, for
n in `KEPT_STEPS`: every row then keeps exactly n, in n steps of the sweep.

Then the wide rows (K > MAX_K: the kernels' wide-row path), K-A in 'min'
and 'union' mode and K-C capped at 20 and 200 in the mode it runs there:
seeded random [2, 8732] ('min', SSD-300's class-wise rows) and [2, 21250]
('union', the realtime head's), as `chip_smoke.py`'s `check_wide_rows`
makes them, and the f32 RON-320 Detector's own [40, 21250] rows ('min')
on the fixture's first two images with top_k 21250, every anchor (cached
beside the main path's rows).

Prints one JSON line: for each kernel and row set, the device time (the
per-launch mean of the kernel's device duration in a torch.profiler trace
of `DEVICE_REPS` launches, CUDA events only), the wrapper's per-call time
(CUDA events around `CALL_REPS` back-to-back calls), the kept count per
row (mean, max) and the first 12 hex digits of a SHA-256 of the mask.
"""

import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FIXTURE = REPO / "tests" / "fixtures" / "e2e_parity_trained.npz"
ROWS_CACHE = REPO / "ron_tensorflow_tpu_torch" / "_build" / "nms_rows_main_path.pt"
WIDE_ROWS_CACHE = REPO / "ron_tensorflow_tpu_torch" / "_build" / "nms_rows_detector_wide.pt"
WIDE_TOP_K = 21250  # RON-320's anchors
WIDE_CAPS = (20, 200)
DEVICE_REPS = 200
CALL_REPS = 50
KEPT_STEPS = (0, 1, 4, 16, 46, 100, 200)
WIDE_REPS = 20  # launches a wide-row call is timed over
PROFILE_WINDOWS = 3


def device_ms(fn, reps=DEVICE_REPS, match="nms", windows=PROFILE_WINDOWS):
    """Per-launch mean of the device duration of the kernels whose name
    holds `match`, over a torch.profiler trace of `reps` calls of fn (one
    warm-up call first). Only the device's own events count (device_type
    CUDA). A window whose trace holds no such event at all (CUPTI has
    returned empty traces on the card host now and then) is taken again,
    up to `windows` in all. Returns (ms, launches seen in the trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and match in e.key]
        if events:
            return sum(device_us(e) for e in events) / reps / 1e3, sum(e.count for e in events)
    raise RuntimeError(f"{windows} profiler traces held no device event named like {match!r}")


def call_ms(fn, reps=CALL_REPS):
    """Mean milliseconds per call of fn, CUDA events around reps calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main_path_rows():
    """[640, 200] NMS rows of the bf16 batch-32 Detector on the fixture."""
    import numpy as np
    import torch

    from ron_tensorflow_tpu_torch.data.preprocess import eval_preprocess
    from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, Detector
    from ron_tensorflow_tpu_torch.models.ron import RON
    from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC
    from ron_tensorflow_tpu_torch.weights import from_jax_params, load_trained_fixture

    if ROWS_CACHE.exists():
        return torch.load(ROWS_CACHE, map_location="cuda")
    fx = np.load(FIXTURE, allow_pickle=False)
    images = torch.stack([
        eval_preprocess(torch.as_tensor(fx[f"img_{i}_pixels"], device="cuda").float() / 255.0,
                        RON_320_SPEC.img_shape)[0]
        for i in ("1", "2", "3", "4")
    ])
    model = RON(RON_320_SPEC, dtype=torch.bfloat16, fuse_block1=True)
    model.load_state_dict(from_jax_params(*load_trained_fixture(str(FIXTURE))), strict=True)
    det = Detector(model, RON_320_SPEC, DetectionConfig(), device="cuda")
    with torch.inference_mode():
        rows = tuple(t.contiguous() for t in det.candidates(det.model(images.repeat(8, 1, 1, 1))))
    ROWS_CACHE.parent.mkdir(parents=True, exist_ok=True)
    torch.save(rows, ROWS_CACHE)
    return rows


def detector_wide_rows():
    """[40, 21250] NMS rows of the f32 RON-320 Detector with top_k at every
    anchor on the fixture's first two images."""
    import dataclasses

    import numpy as np
    import torch

    from ron_tensorflow_tpu_torch.data.preprocess import eval_preprocess
    from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, Detector
    from ron_tensorflow_tpu_torch.models.ron import RON
    from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC
    from ron_tensorflow_tpu_torch.weights import from_jax_params, load_trained_fixture

    if WIDE_ROWS_CACHE.exists():
        return torch.load(WIDE_ROWS_CACHE, map_location="cuda")
    fx = np.load(FIXTURE, allow_pickle=False)
    images = torch.stack([
        eval_preprocess(torch.as_tensor(fx[f"img_{i}_pixels"], device="cuda").float() / 255.0,
                        RON_320_SPEC.img_shape)[0]
        for i in ("1", "2")
    ])
    model = RON(RON_320_SPEC, dtype=torch.float32)
    model.load_state_dict(from_jax_params(*load_trained_fixture(str(FIXTURE))), strict=True)
    det = Detector(model, RON_320_SPEC, dataclasses.replace(DetectionConfig(), top_k=WIDE_TOP_K), device="cuda")
    with torch.inference_mode():
        rows = tuple(t.contiguous().clone() for t in det.candidates(det.model(images)))
    WIDE_ROWS_CACHE.parent.mkdir(parents=True, exist_ok=True)
    torch.save(rows, WIDE_ROWS_CACHE)
    return rows


def random_rows(seed, r, k):
    """Score-sorted random rows (a fifth of the scores 0) on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    cy, cx = torch.rand(2, r, k, generator=g) * 0.6 + 0.2
    h, w = torch.rand(2, r, k, generator=g) * 0.35 + 0.05
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    scores = torch.where(torch.rand(r, k, generator=g) < 0.2, 0.0, torch.rand(r, k, generator=g))
    scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return scores.cuda().contiguous(), boxes.cuda().contiguous()


def kept_n_rows(n, r=640, k=200):
    """[r, k] rows of boxes in disjoint grid cells whose first n scores are
    > 0: each row keeps exactly its first n candidates."""
    import torch

    side = int(k ** 0.5 + 0.999999)
    cell = torch.arange(k)
    y0, x0 = (cell // side) / side, (cell % side) / side
    boxes = torch.stack([y0, x0, y0 + 0.5 / side, x0 + 0.5 / side], -1).repeat(r, 1, 1)
    scores = torch.where(cell < n, torch.linspace(1.0, 0.01, k), 0.0).repeat(r, 1)
    return scores.cuda().contiguous(), boxes.cuda().contiguous()


def main(root):
    sys.path.insert(0, str(root))
    import torch

    from ron_tensorflow_tpu_torch import kernels
    from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig

    if not torch.cuda.is_available():
        raise SystemExit("time_nms.py needs a CUDA device")
    cfg = DetectionConfig()
    thr, mode, cap = cfg.nms_threshold, cfg.nms_mode, cfg.keep_top_k
    row_sets = {"main [640, 200]": main_path_rows()}
    try:
        kernels.nms_scan_keep_mask(*random_rows(0, 1, 2048))
        row_sets["random [32, 2048]"] = random_rows(1, 32, 2048)
    except ValueError:  # a copy whose kernels refuse K > 1024
        pass
    result = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    for label, (s, b) in row_sets.items():
        for name, fn in (
            ("K-A", lambda: kernels.nms_fixpoint_keep_mask(s, b, thr, mode)),
            ("K-C", lambda: kernels.nms_scan_keep_mask(s, b, thr, cap, mode)),
        ):
            keep = fn()
            per_row = keep.sum(-1).float()
            dev, seen = device_ms(fn)
            result[f"{name} {label}"] = {
                "device_ms": dev, "launches_traced": seen, "call_ms": call_ms(fn),
                "kept_mean": float(per_row.mean()), "kept_max": int(per_row.max()),
                "mask": hashlib.sha256(keep.cpu().numpy().tobytes()).hexdigest()[:12],
            }
    for n in KEPT_STEPS:
        s, b = kept_n_rows(n)
        result[f"kept {n} [640, 200]"] = {
            "K-A device_ms": device_ms(lambda: kernels.nms_fixpoint_keep_mask(s, b, thr, mode))[0],
            "K-C device_ms": device_ms(lambda: kernels.nms_scan_keep_mask(s, b, thr, 200, mode))[0],
        }
    wide_sets = {
        "random [2, 8732]": (random_rows(8732 + 11, 2, 8732), "min"),
        "random [2, 21250]": (random_rows(WIDE_TOP_K + 11, 2, WIDE_TOP_K), "union"),
        "Detector [40, 21250]": (detector_wide_rows(), cfg.nms_mode),
    }
    for label, ((s, b), scan_mode) in wide_sets.items():
        calls = {f"K-A {m}": (lambda m=m: kernels.nms_fixpoint_keep_mask(s, b, thr, m)) for m in ("min", "union")}
        calls.update({f"K-C {scan_mode} cap {c}": (lambda c=c: kernels.nms_scan_keep_mask(s, b, thr, c, scan_mode))
                      for c in WIDE_CAPS})
        for name, fn in calls.items():
            keep = fn()
            per_row = keep.sum(-1).float()
            dev, seen = device_ms(fn, reps=WIDE_REPS)
            result[f"{name} {label}"] = {
                "device_ms": dev, "launches_traced": seen, "call_ms": call_ms(fn, reps=WIDE_REPS),
                "kept_mean": float(per_row.mean()), "kept_max": int(per_row.max()),
                "mask": hashlib.sha256(keep.cpu().numpy().tobytes()).hexdigest()[:12],
            }
    print(json.dumps(result))


if __name__ == "__main__":
    main(Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else REPO)
