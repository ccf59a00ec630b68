"""`utils/profiling.py` on the CPU. `profile_trace` writes a Chrome trace
of the enclosed work under its logdir (torch.profiler's
`tensorboard_trace_handler` layout) and nothing when disabled; asked for
the card where there is none, it raises rather than record the host alone.
Its CUDA events are checked on the card (`chip_smoke.py` phase "zoo").

The tracer: off, a span is one shared no-op that touches neither CUDA
events nor the profiler; enabled, nested spans add their host times and
calls, counters their totals a call of the enclosing span, and device
times come from event pairs read without waiting (a fake event here),
in bounded memory; under a profiler, spans are host ranges `ron.<name>`."""

import json
import time

import pytest
import torch

from ron_tensorflow_tpu_torch.utils import profiling
from ron_tensorflow_tpu_torch.utils.profiling import StepTimer, profile_trace


def test_profile_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    a = torch.randn(64, 64)
    with profile_trace(str(logdir), device="cpu"):
        torch.mm(a, a).relu_()
    (trace,) = list(logdir.glob("*.pt.trace.json"))
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "cpu_op"}
    assert {"aten::mm", "aten::relu_"} <= names
    assert not any(e.get("cat") == "kernel" for e in events)


def test_profile_trace_disabled_writes_nothing(tmp_path):
    with profile_trace(str(tmp_path / "trace"), enabled=False, device="cpu"):
        torch.ones(3).sum()
    assert not (tmp_path / "trace").exists()


def test_profile_trace_does_not_drop_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        with profile_trace(str(tmp_path / "trace")):
            pass
    assert not (tmp_path / "trace").exists()


def test_step_timer():
    t = StepTimer(window=3)
    assert t.sec_per_step == 0.0 and t.images_per_sec(8) == 0.0
    for _ in range(5):
        t.tick()
    assert len(t._times) == 3 and t.sec_per_step > 0 and t.images_per_sec(8) > 0


# --------------------------------------------------------------------------- #
# The tracer: `span`, `count`, `snapshot`


@pytest.fixture
def tracer():
    """The tracer reset and enabled for one test, off and empty after it."""
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


class FakeEvent:
    """A CUDA event's timing API on the host clock: `done` says whether the
    card has reached it (`query`), `synchronize` makes it so."""

    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t, self.done, self.waited = None, False, False

    def record(self, stream=None):
        self.t, self.done, self.waited = time.perf_counter(), False, False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = self.waited = True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class FakeStream:
    device_index = 0


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda.Event and current_stream replaced, so that spans on a
    'cuda' device record their events on the CPU."""
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: FakeStream())
    monkeypatch.setattr(profiling, "_free", {})
    return FakeEvent


def test_span_is_the_shared_no_op_while_nothing_reads_it(monkeypatch):
    touched = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: touched.append("event"))
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: touched.append("range"))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", lambda *a, **k: touched.append("range"))
    assert not profiling.enabled()
    for device in (None, torch.device("cpu"), torch.device("cuda")):
        s = profiling.span("detect.call", device)
        assert s is profiling.NULL_SPAN
        with s:
            profiling.count("detect.h2d_bytes", 8)
    assert touched == [] and profiling.snapshot() == {"spans": {}, "counters": {}}


def test_nested_spans_time_the_host_and_count_calls(tracer):
    for _ in range(3):
        with tracer.span("x.call"):
            with tracer.span("x.inner"):
                time.sleep(0.002)
            time.sleep(0.001)
    snap = tracer.snapshot()["spans"]
    assert {n: s["calls"] for n, s in snap.items()} == {"x.call": 3, "x.inner": 3}
    assert snap["x.inner"]["host_ms"] >= 2.0 and snap["x.call"]["host_ms"] >= snap["x.inner"]["host_ms"] + 1.0
    assert snap["x.call"]["host_max_ms"] >= snap["x.call"]["host_ms"]
    assert snap["x.call"]["device_ms"] is None  # no CUDA device: no device time


def test_counters_per_call_of_their_enclosing_span(tracer):
    for n in (10, 30):
        with tracer.span("a.call"):
            tracer.count("a.h2d_bytes", n)
    with tracer.span("b.step"):
        tracer.count("b.h2d_bytes", 5)
    tracer.count("c.items", 7)
    counters = tracer.snapshot()["counters"]
    assert counters == {"a.h2d_bytes": {"total": 40, "per_call": 20.0},
                        "b.h2d_bytes": {"total": 5, "per_call": 5.0},
                        "c.items": {"total": 7, "per_call": None}}
    table = tracer.format_snapshot(tracer.snapshot())
    assert "a.call" in table and "a.h2d_bytes" in table and "20.0" in table


def test_device_times_are_read_without_waiting_and_stay_bounded(tracer, fake_card):
    """Finished event pairs are read by `query()` once `PENDING_LIMIT` wait;
    none is waited for while the card keeps up, and the pending list never
    passes the limit, also when the card falls behind."""
    device = torch.device("cuda")
    n = 3 * profiling.PENDING_LIMIT
    for _ in range(n):
        with tracer.span("k.call", device):
            pass
        for *_, end in profiling._pending:
            end.done = True  # the card keeps up
        assert len(profiling._pending) < profiling.PENDING_LIMIT
    assert not any(e.waited for _, _, s, e in profiling._pending)
    assert fake_card.made < n  # finished events are reused
    for _ in range(n):  # the card falls behind: the oldest pair is waited for
        with tracer.span("k.call", device):
            pass
        assert len(profiling._pending) < profiling.PENDING_LIMIT
    snap = tracer.snapshot()["spans"]["k.call"]
    assert snap["calls"] == 2 * n and snap["device_ms"] is not None and snap["device_ms"] >= 0
    assert profiling._pending == []


def test_since_gives_the_means_between_two_snapshots(tracer, fake_card):
    with tracer.span("t.step", torch.device("cuda")):
        time.sleep(0.02)
    before = tracer.snapshot()
    for _ in range(2):
        with tracer.span("t.step", torch.device("cuda")):
            time.sleep(0.001)
    means = tracer.since(before, tracer.snapshot())
    assert list(means) == ["t.step"]
    assert 1.0 <= means["t.step"]["host_ms"] < 15.0 and 1.0 <= means["t.step"]["device_ms"] < 15.0
    assert tracer.since(tracer.snapshot(), tracer.snapshot()) == {}


def test_spans_open_host_ranges_under_the_profiler():
    """While a profiler runs, a span is the profiler's range `ron.<name>`
    (a function-scope record, so the profiler draws no copy of it on the
    device's timeline), also with the tracer off."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("p.call"):
            with profiling.span("p.inner"):
                torch.ones(4).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    outer, inner = events["ron.p.call"], events["ron.p.inner"]
    assert outer.start_ns() <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= outer.start_ns() + outer.duration_ns()
    assert str(outer.device_type()).endswith("CPU")
    assert profiling.span("p.call") is profiling.NULL_SPAN  # the profiler has stopped


def test_trainer_logs_span_means_and_counts_its_uploads(tracer, tmp_path):
    """With the tracer enabled, `Trainer.train` writes each span's mean host
    ms since the previous log step into metrics.jsonl, and the upload's
    bytes (every host batch is uploaded whole) go to `train.h2d_bytes`."""
    import numpy as np

    from ron_tensorflow_tpu_torch.config import TrainConfig, apply_overrides
    from ron_tensorflow_tpu_torch.train.trainer import Trainer

    cfg = apply_overrides(TrainConfig(), [
        "model=ron_tiny_vgg", f"model_dir={tmp_path}", "data.batch_size=1", "bfloat16=false", "max_steps=2",
        "log_every_steps=1", "save_every_steps=1000", "optimizer.learning_rate_decay_type=fixed"])
    rng = np.random.default_rng(0)
    host = {"image01": rng.integers(0, 256, (1, 64, 64, 3)).astype(np.uint8),
            "gt_boxes": np.array([[[0.2, 0.2, 0.7, 0.6]]], np.float32), "gt_labels": np.array([[3]], np.int32),
            "gt_valid": np.array([[True]])}
    trainer = Trainer(cfg, device="cpu")
    trainer._ckpt.save = lambda step, state: None
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        trainer.train(batches=iter([host, host]))
    finally:
        torch.set_num_threads(n)
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    stages = ("step", "augment", "encode", "forward_loss", "backward", "update")
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert all(r[f"span/train.{s}_host_ms"] > 0 for s in stages)
        assert r["span/train.step_host_ms"] >= r["span/train.backward_host_ms"]
        assert not any(k.endswith("_device_ms") for k in r)
    snap = tracer.snapshot()
    assert snap["spans"]["train.step"]["calls"] == 2
    assert snap["counters"]["train.h2d_bytes"]["per_call"] == sum(v.nbytes for v in host.values())


@pytest.mark.parametrize("command", ["infer", "bench"])
def test_cli_spans_flag_enables_the_tracer_and_prints_its_table(monkeypatch, capsys, command):
    """`--spans` enables the tracer for train, eval, realtime-eval and infer
    only, and prints its table on standard error at exit, the tracer off
    again."""
    from ron_tensorflow_tpu_torch import cli

    seen = []

    def fake(args):
        seen.append(profiling.enabled())
        with profiling.span("realtime.call"):
            profiling.count("realtime.h2d_bytes", 12)

    monkeypatch.setattr(cli, f"cmd_{command}", fake)
    argv = ["--spans", "--device", "cpu", command] + (["--model-dir", "m", "a.jpg"] if command == "infer" else [])
    cli.main(argv)
    err = capsys.readouterr().err
    traced = command == "infer"
    assert seen == [traced] and not profiling.enabled()
    assert ("realtime.call" in err and "realtime.h2d_bytes" in err) == traced
    profiling.reset()
