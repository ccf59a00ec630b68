"""Time the bf16 batch-32 Detector with this checkout's kernel library against
another checkout's, in turns in one process.

    python3 ron_tensorflow_tpu_torch/tools/ab_detector.py OTHER_ROOT [ROUNDS]

OTHER_ROOT is a copy of the repository (for example a `git archive` of the
parent commit unpacked under the gitignored `_checkouts/`) whose kernels
keep the C signatures of this checkout's. Both libraries are built with
their own `_build.py` and loaded side by side; the Detector (this
checkout's Python, the trained fixture's weights, its four images tiled to
batch 32, fused block 1) then calls one library or the other, in the order
A B B A for each of ROUNDS rounds (default 5). Each turn times `REPS`
batches with CUDA events after a warm-up batch, and the NMS stage alone
(`nms_sorted_kernel` on the batch's candidates) the same way. Comparing in
one process removes what differs between processes (allocations, cuDNN's
choices, the card's state at start), which moves the forward by more than
the whole NMS stage.

Prints one JSON line: per library, the per-turn batch milliseconds and NMS
stage milliseconds, their means, and img/s from the mean batch time.
"""

import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FIXTURE = REPO / "tests" / "fixtures" / "e2e_parity_trained.npz"
REPS = 20


def load_build(root):
    """The `_build` module of the copy at root, loaded under its own name."""
    path = Path(root) / "ron_tensorflow_tpu_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{abs(hash(str(path)))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(other, rounds):
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from ron_tensorflow_tpu_torch.data.preprocess import eval_preprocess
    from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, Detector
    from ron_tensorflow_tpu_torch.kernels import _build
    from ron_tensorflow_tpu_torch.kernels.nms import nms_sorted_kernel
    from ron_tensorflow_tpu_torch.models.ron import RON
    from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC
    from ron_tensorflow_tpu_torch.weights import from_jax_params, load_trained_fixture

    if not torch.cuda.is_available():
        raise SystemExit("ab_detector.py needs a CUDA device")
    libs = {"this": _build.library(), "other": load_build(other).library()}
    fx = np.load(FIXTURE, allow_pickle=False)
    images = torch.stack([
        eval_preprocess(torch.as_tensor(fx[f"img_{i}_pixels"], device="cuda").float() / 255.0,
                        RON_320_SPEC.img_shape)[0]
        for i in ("1", "2", "3", "4")
    ])
    batch = images.repeat(8, 1, 1, 1).contiguous()
    model = RON(RON_320_SPEC, dtype=torch.bfloat16, fuse_block1=True)
    model.load_state_dict(from_jax_params(*load_trained_fixture(str(FIXTURE))), strict=True)
    det = Detector(model, RON_320_SPEC, DetectionConfig(), device="cuda")
    cfg = det.config

    def mean_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    turns = {name: {"batch_ms": [], "nms_ms": []} for name in libs}
    with torch.inference_mode():
        flat_s, flat_b = (t.contiguous() for t in det.candidates(det.model(batch)))
        for _ in range(rounds):
            for name in ("this", "other", "other", "this"):
                _build.library = lambda lib=libs[name]: lib  # the wrappers call _build.library()
                turns[name]["batch_ms"].append(mean_ms(lambda: det(batch)))
                turns[name]["nms_ms"].append(mean_ms(lambda: nms_sorted_kernel(
                    flat_s, flat_b, cfg.nms_threshold, cfg.keep_top_k, cfg.nms_mode)))
    result = {"other": str(other), "device": torch.cuda.get_device_name(0), "reps": REPS}
    for name, t in turns.items():
        mean = sum(t["batch_ms"]) / len(t["batch_ms"])
        result[name] = {**t, "batch_ms_mean": mean, "img_per_s": batch.shape[0] * 1e3 / mean,
                        "nms_ms_mean": sum(t["nms_ms"]) / len(t["nms_ms"])}
    print(json.dumps(result))


if __name__ == "__main__":
    main(Path(sys.argv[1]).resolve(), int(sys.argv[2]) if len(sys.argv) > 2 else 5)
