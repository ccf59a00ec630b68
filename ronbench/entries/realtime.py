"""Realtime frames: the port's `RealtimeDetector` as `cli infer` builds it
(block 1 unfused, the whole-image head, K-C), called synchronously by one
client with a batch of whitened float32 host frames; each call's
detections are copied back to the host before the next call.

Set-up draws `pool_batches` x `batch` scenes from the seed and keeps them
whitened on the host, in pinned memory where the traffic says so (as a
video pipeline decodes into pinned buffers), else pageable.
Each call is timed on the host clock from handing over the frames to its
detections on the host; the window ends at the first call to finish after
`seconds`, and every call in it counts.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from ronbench import scenes, verify
from ronbench import weights as W
from ronbench.program import Recorder, Stages, build_model, heads_of, marker, sample_pass, synchronize


def setup(plan, seed: int, device: torch.device):
    from ron_tensorflow_tpu_torch.inference.detector import RealtimeConfig, RealtimeDetector

    cfg, tr, stage = plan.config, plan.traffic, Stages()
    (h, w), b, p = cfg["img_shape"], tr["batch"], tr["pool_batches"]
    pixels, _ = scenes.draw_pool(seed, b * p, h, w, tr["scenes"])
    stage("scenes")
    frames = torch.from_numpy(scenes.whiten(pixels).reshape(p, b, h, w, 3))
    if tr["pinned_frames"] and device.type == "cuda":
        frames = frames.pin_memory()
    weights = W.load(cfg, seed, device, plan.root)
    stage("weights")
    model, spec = build_model(cfg, weights, device, tr["fuse_block1"])
    stage("model")
    rt = RealtimeDetector(model, spec, RealtimeConfig(**cfg["realtime"]), device=device)
    rt.model = Recorder(rt.model)
    state = SimpleNamespace(plan=plan, device=device, frames=frames, weights=weights, program=rt,
                            sample_pass=sample_pass(seed, tr["sample_passes"]), sampled={})
    for j in range(tr["warmup_calls"]):
        [t.cpu() for t in rt(frames[j % p])]
    synchronize(device)
    stage("warm-up")
    stage.report(plan.name)
    return state


def window(state, seconds: float, spans=None, sample: bool = True, profiling: bool = False) -> dict:
    rt, frames, mark = state.program, state.frames, marker(profiling)
    rec, (p, b) = rt.model, frames.shape[:2]
    need = (state.sample_pass + 1) * p if sample else 0
    latencies, k, t0 = [], 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds or k < need:
        j = k % p
        rec.keep, rec.spans = sample and k // p == state.sample_pass, spans
        with mark("ronbench.call"):
            t = time.perf_counter()
            if spans is not None:
                spans.start()
            out = rt(frames[j])
            if spans is not None:
                spans.mark("call_end")
            [x.cpu() for x in out]
            latencies.append((time.perf_counter() - t) * 1e3)
        if rec.keep:
            state.sampled[j] = (heads_of(rec.kept), out)
        k += 1
    t1 = time.perf_counter()
    rec.keep, rec.spans = False, None
    return {"images": k * b, "calls": k, "window_s": t1 - t0, "latencies_ms": latencies, "attempted": k * b,
            "failed": 0}


def check(state):
    """-> (checks, counters for the readers). Frees the program first."""
    return verify.check(state, "realtime", "rt_mismatch",
                        lambda out: dict(zip(("scores", "labels", "boxes", "valid"), out)),
                        lambda j: state.frames[j].to(state.device))
