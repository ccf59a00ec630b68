"""Time the streaming evaluator and the realtime head of this checkout's
package against another checkout's, in turns in one process.

    python3 ron_tensorflow_tpu_torch/tools/ab_eval.py OTHER_ROOT [ROUNDS]

OTHER_ROOT is a copy of the repository, or of its `ron_tensorflow_tpu_torch/`
alone (for example `git archive` of the parent commit unpacked under the
gitignored `_checkouts/`). Its package is loaded beside this one under
another name, with its own Python and its own kernel library (built by its
`_build.py`). Each side builds the bf16 RON-320 with fused block 1 and the
trained fixture's weights, a `StreamingEvaluator` (the default
`DetectionConfig`, no `loss_config`) and a `RealtimeDetector` (the default
`RealtimeConfig`), as `chip_smoke.py`'s phase "timing" does. Then, in the
order A B B A for each of ROUNDS rounds (default 3), each side's evaluator
runs `EVAL_BATCHES` batches of 32 (the fixture's four images tiled, their
realtime references as the gts; host clock around `run`, which ends with
every result on the host) and its realtime head takes `REPS` batches of 32
(CUDA events). One process keeps the card's state, the allocator and
cuDNN's choices alike for both.

Prints one JSON line: per side, the per-turn images/s of each and their
means.
"""

import importlib.util
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FIXTURE = REPO / "tests" / "fixtures" / "e2e_parity_trained.npz"
IMAGES = ("1", "2", "3", "4")
BATCH, EVAL_BATCHES, REPS = 32, 4, 5


def load_package(root, name):
    """The `ron_tensorflow_tpu_torch` package of the copy at root, imported
    as `name` (its modules import each other relatively)."""
    init = Path(root) / "ron_tensorflow_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(name, init, submodule_search_locations=[str(init.parent)])
    package = importlib.util.module_from_spec(spec)
    sys.modules[name] = package
    spec.loader.exec_module(package)
    return package


def side(name, fx, np, torch):
    """(evaluate, realtime): zero-argument callables timing one turn of the
    package `name`'s streaming evaluator and realtime head."""
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    spec = mod("models.spec").RON_320_SPEC
    weights = mod("weights")
    model = mod("models.ron").RON(spec, dtype=torch.bfloat16, fuse_block1=True)
    model.load_state_dict(weights.from_jax_params(*weights.load_trained_fixture(str(FIXTURE))), strict=True)
    eval_preprocess = mod("data.preprocess").eval_preprocess
    images = torch.stack([eval_preprocess(torch.as_tensor(fx[f"img_{i}_pixels"], device="cuda").float() / 255.0,
                                          spec.img_shape)[0] for i in IMAGES])
    batch = images.repeat(BATCH // len(IMAGES), 1, 1, 1).contiguous()
    refs = [(fx[f"img_{i}_rt_published_labels"], fx[f"img_{i}_rt_published_boxes"]) for i in IMAGES]
    g = max(len(lab) for lab, _ in refs)
    labels, boxes = np.zeros((len(IMAGES), g), np.int32), np.zeros((len(IMAGES), g, 4), np.float32)
    for i, (lab, bx) in enumerate(refs):
        labels[i, :len(lab)], boxes[i, :len(lab)] = lab, bx
    reps = BATCH // len(IMAGES)
    gts = {"gt_labels": np.tile(labels, (reps, 1)), "gt_boxes": np.tile(boxes, (reps, 1, 1)),
           "gt_difficult": np.zeros((BATCH, g), np.int32)}
    batches = [{"image": batch, **gts} for _ in range(EVAL_BATCHES)]
    ev = mod("eval.evaluator").StreamingEvaluator(model, spec, mod("inference.detector").DetectionConfig(),
                                                  device="cuda")
    detector = mod("inference.detector")
    rt = detector.RealtimeDetector(model, spec, detector.RealtimeConfig(), device="cuda")
    net = spec.img_shape[0] * spec.img_shape[1]
    min_size = torch.tensor([rt.config.min_size * float(np.sqrt(fx[f"img_{i}_pixels"].shape[0]
                                                                 * fx[f"img_{i}_pixels"].shape[1] / net))
                             for i in IMAGES] * reps, dtype=torch.float32, device="cuda")

    def evaluate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, stats = ev.run(iter(batches), log_every=0)
        return stats["images"] / (time.perf_counter() - t0)

    def realtime():
        with torch.inference_mode():
            rt(batch, min_size)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                rt(batch, min_size)
            end.record()
            end.synchronize()
        return BATCH * 1e3 * REPS / start.elapsed_time(end)

    evaluate()  # warm-up: cuDNN's choices, the allocator
    return evaluate, realtime


def main(other, rounds):
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_eval.py needs a CUDA device")
    import ron_tensorflow_tpu_torch  # noqa: F401

    load_package(other, "ron_other")
    fx = np.load(FIXTURE, allow_pickle=False)
    sides = {"this": side("ron_tensorflow_tpu_torch", fx, np, torch), "other": side("ron_other", fx, np, torch)}
    turns = {name: {"evaluator_img_per_s": [], "realtime_b32_img_per_s": []} for name in sides}
    for _ in range(rounds):
        for name in ("this", "other", "other", "this"):
            evaluate, realtime = sides[name]
            turns[name]["evaluator_img_per_s"].append(evaluate())
            turns[name]["realtime_b32_img_per_s"].append(realtime())
    result = {"other": str(other), "device": torch.cuda.get_device_name(0), "batches": EVAL_BATCHES, "reps": REPS}
    for name, t in turns.items():
        result[name] = {**t, **{f"{k}_mean": sum(v) / len(v) for k, v in t.items()}}
    print(json.dumps(result))


if __name__ == "__main__":
    main(Path(sys.argv[1]).resolve(), int(sys.argv[2]) if len(sys.argv) > 2 else 3)
