"""The check of a run, once its window has closed: the sampled calls'
head outputs against the reference's forward, and their detections
against the reference's postprocess of those outputs (`compare`); with
them, what the NMS launches of these inputs had to do (`counts`)."""

from __future__ import annotations

import statistics

import torch

from ronbench import compare, counts
from ronbench.program import full_f32
from ronbench.reference import nets, postprocess

SECTIONS = {"detect": "detection", "realtime": "realtime"}


def check(state, head: str, mismatch: str, program_rows, reference_images):
    """-> (checks, counters). `program_rows(out)`: a call's detections as
    `compare.mismatch` takes them; `reference_images(j)`: pool batch j as
    float32 on the device. The program is freed first, so that the
    reference's memory does not raise the run's peak."""
    plan, cfg = state.plan, state.plan.config
    state.program = None
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    dtype = getattr(torch, cfg["postprocess_dtype"])
    section = cfg[SECTIONS[head]]
    test = cfg["nms_test"][SECTIONS[head]]
    worst, lone, total, bounds = 0.0, 0, 0, []
    with torch.inference_mode(), full_f32():
        for j, (prog, out) in sorted(state.sampled.items()):
            ref = nets.heads(cfg, state.weights, reference_images(j))
            worst = max(worst, compare.rel_err(prog, ref))
            del ref
            mine = postprocess.HEADS[head](prog, cfg, dtype)
            n_lone, n = compare.mismatch(program_rows(out), mine)
            lone, total = lone + n_lone, total + n
            rows, boxes, keep = mine["rows"]
            pairs = counts.sweep_pairs(rows, boxes, section["nms_threshold"], section["nms_mode"], keep,
                                       dividing=test == "divide")
            bounds.append(counts.nms_bound_ms(*rows.shape, pairs))
    state.sampled = {}
    checks = [{"name": "heads_rel_err", "value": worst, "limit": plan.limit("heads_rel_err")},
              {"name": mismatch, "value": lone / max(total, 1), "limit": plan.limit(mismatch)}]
    found = {"nms_bound_ms": statistics.fmean(bounds), "flops_per_image": nets.flops_per_image(cfg),
             "detections_compared": total, "calls_compared": len(bounds)}
    return checks, found
