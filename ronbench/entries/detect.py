"""Batched detection: the port's `Detector` over a pool of whitened image
batches on the device, closed loop, one client, two batches in flight.

Set-up draws `pool_batches` x `batch` scenes from the seed at the model's
input size, whitens them and puts them on the device, loads the
configuration's weights, builds the model (K-B where the traffic asks for
it) and the `Detector` with the configuration's detection settings, and
warms that one shape up.

The window cycles the pool: call k is `Detector(pool[k % P])`; its
detections are copied into pinned host memory behind it, and the host
waits for call k's copy only after it has dispatched call k + 1. It ends
at the first wait after `seconds` have passed; every image whose
detections reached the host counts, over the whole time.

The check compares the calls of one pass over the pool, the pass drawn
from the seed (`verify`).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from ronbench import counts, scenes, verify
from ronbench import weights as W
from ronbench.program import Recorder, Stages, build_model, heads_of, marker, sample_pass, synchronize


def setup(plan, seed: int, device: torch.device):
    from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, Detector

    cfg, tr, stage = plan.config, plan.traffic, Stages()
    (h, w), b, p = cfg["img_shape"], tr["batch"], tr["pool_batches"]
    pixels, _ = scenes.draw_pool(seed, b * p, h, w, tr["scenes"])
    stage("scenes")
    pool = torch.from_numpy(scenes.whiten(pixels)).to(device).reshape(p, b, h, w, 3)
    weights = W.load(cfg, seed, device, plan.root)
    stage("weights")
    model, spec = build_model(cfg, weights, device, tr["fuse_block1"])
    stage("model")
    det = Detector(model, spec, DetectionConfig(**cfg["detection"]), device=device)
    det.model = Recorder(det.model)
    state = warm(SimpleNamespace(plan=plan, device=device, pool=pool, weights=weights, program=det,
                                 sample_pass=sample_pass(seed, tr["sample_passes"]), sampled={}))
    stage("warm-up")
    stage.report(plan.name)
    return state


def warm(state):
    """The traffic's warm-up calls, and the host slots the window copies into."""
    for j in range(state.plan.traffic["warmup_calls"]):
        out = state.program(state.pool[j % state.pool.shape[0]])
    pin = state.device.type == "cuda"
    state.slots = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for t in out] for _ in range(2)]
    synchronize(state.device)
    return state


def window(state, seconds: float, spans=None, sample: bool = True, profiling: bool = False) -> dict:
    program, pool, cuda = state.program, state.pool, state.device.type == "cuda"
    rec, (p, b), mark = program.model, pool.shape[:2], marker(profiling)
    need = (state.sample_pass + 1) * p if sample else 0

    def dispatch(k):
        j = k % p
        rec.keep, rec.spans = sample and k // p == state.sample_pass, spans
        with mark("ronbench.dispatch"):
            if spans is not None:
                spans.start()
            out = program(pool[j])
            if spans is not None:
                spans.mark("call_end")
            for dst, src in zip(state.slots[k % 2], out):
                dst.copy_(src, non_blocking=cuda)
            done = torch.cuda.Event() if cuda else None
            if done is not None:
                done.record()
        if rec.keep:
            state.sampled[j] = (heads_of(rec.kept), out)
        return done

    def finish(done):
        with mark("ronbench.fetch"):
            if done is not None:
                done.synchronize()

    calls, t0 = 0, time.perf_counter()
    pending, k = dispatch(0), 1
    while time.perf_counter() - t0 < seconds or k < need:
        nxt = dispatch(k)
        k += 1
        finish(pending)
        calls += 1
        pending = nxt
    finish(pending)
    calls += 1
    t1 = time.perf_counter()
    rec.keep, rec.spans = False, None
    return {"images": calls * b, "calls": calls, "window_s": t1 - t0, "attempted": calls * b, "failed": 0}


def check(state):
    """-> (checks, counters for the readers). Frees the program first."""
    checks, found = verify.check(state, "detect", "det_mismatch",
                                 lambda out: {"scores": out[0], "boxes": out[1]}, lambda j: state.pool[j].float())
    (h, w), b = state.plan.config["img_shape"], state.plan.traffic["batch"]
    flops, nbytes = counts.block_cost(b, h, w, 3, 64)
    found["kb_bound_ms"] = counts.bound(nbytes, flops, counts.PEAK_BF16_FLOPS)[0]
    return checks, found
