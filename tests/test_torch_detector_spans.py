"""The detection heads' spans and counters (`utils/profiling.py`) on the
CPU, on the tiny RON: with the tracer off a `Detector` or
`RealtimeDetector` call makes no CUDA event and opens no profiler range;
the tracer changes no output bit; `*.h2d_bytes` counts a host batch's bytes
and nothing for a batch already on the device; under a profiler the
`ron.detect.*` and `ron.realtime.*` ranges nest as the stages do."""

import dataclasses

import numpy as np
import pytest
import torch

from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, Detector, RealtimeConfig, RealtimeDetector
from ron_tensorflow_tpu_torch.models import get_network
from ron_tensorflow_tpu_torch.utils import profiling

# gates open, so that a seeded model's outputs reach top-k and NMS
DETECT = DetectionConfig(objectness_threshold=0.0, select_threshold=0.0, top_k=16, keep_top_k=8)
REALTIME = RealtimeConfig(objectness_threshold=0.0, select_threshold=0.0, top_k=32, keep_top_k=8)
STAGES = ("upload", "forward", "decode", "topk", "nms")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def heads():
    torch.manual_seed(0)
    model, spec = get_network("ron_tiny_vgg")
    images = np.random.default_rng(0).normal(size=(2, *spec.img_shape, 3)).astype(np.float32)
    return {
        "detect": Detector(model, spec, DETECT, device="cpu"),
        "detect_shared": Detector(model, spec, dataclasses.replace(DETECT, shared_top_k=64), device="cpu"),
        "realtime": RealtimeDetector(model, spec, REALTIME, device="cpu"),
        "realtime_classwise": RealtimeDetector(model, spec, dataclasses.replace(REALTIME, class_wise=True),
                                               device="cpu"),
    }, images


@pytest.fixture
def tracer():
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


def test_tracer_off_makes_no_event_and_opens_no_range(heads, monkeypatch):
    dets, images = heads
    touched = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: touched.append("event"))
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: touched.append("range"))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", lambda *a, **k: touched.append("range"))
    for det in dets.values():
        det(images)
    assert touched == [] and profiling.snapshot() == {"spans": {}, "counters": {}}


def test_outputs_bit_equal_with_the_tracer_on_and_off(heads, tracer):
    dets, images = heads
    for name, det in dets.items():
        tracer.disable()
        off = det(images)
        tracer.enable()
        on = det(images)
        assert len(on) == len(off)
        for a, b in zip(on, off):
            assert torch.equal(a, b), name
        assert (off[0] > 0).any(), name  # detections reached the output
    spans = tracer.snapshot()["spans"]
    assert spans["detect.call"]["calls"] == 2 and spans["realtime.call"]["calls"] == 2
    assert spans["detect.topk"]["calls"] == 3  # shared_top_k's preselection is a second top-k
    assert all(spans[f"{head}.{stage}"]["calls"] == 2 for head in ("detect", "realtime") for stage in STAGES
               if (head, stage) != ("detect", "topk"))


def test_h2d_bytes_counts_a_host_batch_not_one_on_the_device(heads, tracer):
    dets, images = heads
    for head in ("detect", "realtime"):
        dets[head](images)
        dets[head](torch.from_numpy(images))  # already on the (CPU) device
    counters = tracer.snapshot()["counters"]
    assert counters["detect.h2d_bytes"] == {"total": images.nbytes, "per_call": images.nbytes / 2}
    assert counters["realtime.h2d_bytes"] == {"total": images.nbytes, "per_call": images.nbytes / 2}


def ranges(prof) -> dict:
    """{range name: [(start, end)]} of the `ron.*` ranges in a profile."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ron."):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def inside(inner, outer) -> bool:
    return all(any(a0 <= b0 and b1 <= a1 for a0, a1 in outer) for b0, b1 in inner)


def test_stage_ranges_nest_under_the_profiler(heads):
    from torch.profiler import ProfilerActivity, profile

    dets, images = heads
    for head, det in (("detect", dets["detect_shared"]), ("realtime", dets["realtime"])):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            det(images)
        got = ranges(prof)
        call = got.pop(f"ron.{head}.call")
        assert len(call) == 1
        assert sorted(got) == sorted(f"ron.{head}.{stage}" for stage in STAGES)
        assert all(inside(r, call) for r in got.values())
        if head == "detect":  # the preselection's top-k inside the decode; the per-class one after it
            (decode,) = got["ron.detect.decode"]
            assert sum(inside([r], [decode]) for r in got["ron.detect.topk"]) == 1
        else:
            order = [got[f"ron.realtime.{stage}"][0] for stage in STAGES]
            assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
