"""`utils/profiling.py::profile_trace` on the CPU: it writes a Chrome trace
of the enclosed work under its logdir (torch.profiler's
`tensorboard_trace_handler` layout) and nothing when disabled; asked for
the card where there is none, it raises rather than record the host alone.
Its CUDA events are checked on the card (`chip_smoke.py` phase "zoo")."""

import json

import pytest
import torch

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
