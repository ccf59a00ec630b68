"""`correct` comes out false for a broken program: a run on the CPU (the
look for a card skipped) of the tiny cells, with the timed path broken
underneath at the faults each cell can have, and with the control (the
reference one precision step down) in the program's place."""

from types import SimpleNamespace

import pytest
import torch

from ronbench import control, harness

import tiny


class Faulty:
    """The program with its answers passed through `fault`."""

    def __init__(self, program, fault):
        self.program, self.fault = program, fault

    @property
    def model(self):
        return self.program.model

    def __call__(self, images):
        return self.fault(self.program(images))


def half_left_out(out):
    """The second half of the batch never computed: zeros come back for it."""
    out = [t.clone() for t in out]
    for t in out:
        t[t.shape[0] // 2:] = 0
    return tuple(out)


def answer_altered(out):
    """One image's answer, that of the image with the call's best
    detection, comes back with its scores halved."""
    scores = out[0].clone()
    image = int(torch.argmax(scores.reshape(scores.shape[0], -1).amax(-1)))
    scores[image] *= 0.5
    return (scores, *out[1:])


def run(tmp_path, cell, wrap=None):
    plan = harness.resolve(tiny.tiny_root(tmp_path), cell)
    if wrap is not None:
        original = plan.entry.setup

        def setup(plan_, seed, device):
            state = original(plan_, seed, device)
            wrap(state)
            return state

        plan.entry = SimpleNamespace(**{**vars(plan.entry), "setup": setup})
    return harness.run_cell(plan, 2**31 + 3, 0.2, False, "cpu", 0.0)


@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.realtime", "tiny.train"])
def test_a_sound_run_is_correct(tmp_path, cell):
    assert run(tmp_path, cell)["correct"] is True


@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.realtime"])
@pytest.mark.parametrize("fault", [half_left_out, answer_altered])
def test_a_fault_of_the_timed_path_is_not_correct(tmp_path, cell, fault):
    def wrap(state):
        state.program = Faulty(state.program, fault)

    out = run(tmp_path, cell, wrap)
    assert out["correct"] is False
    mismatch = out["checks"]["det_mismatch" if cell == "tiny.detect" else "rt_mismatch"]
    assert mismatch["value"] > mismatch["limit"]


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_a_fault_of_the_train_step_is_not_correct(tmp_path, fault):
    with control.planted(fault):
        out = run(tmp_path, "tiny.train")
    assert out["correct"] is False
    assert out["checks"]["change_norm_gap"]["value"] > out["checks"]["change_norm_gap"]["limit"]


def test_the_train_control_is_not_correct(tmp_path):
    out = run(tmp_path, "tiny.train", control.put_control)
    assert out["correct"] is False
    assert out["checks"]["grad_norm_gap"]["value"] > out["checks"]["grad_norm_gap"]["limit"]


@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.realtime"])
def test_the_control_is_not_correct(tmp_path, cell):
    out = run(tmp_path, cell, control.put_control)
    assert out["correct"] is False
    heads = out["checks"]["heads_rel_err"]
    assert heads["value"] > 3 * heads["limit"] or heads["value"] > heads["limit"]
    mismatch = out["checks"]["det_mismatch" if cell == "tiny.detect" else "rt_mismatch"]
    assert mismatch["value"] > mismatch["limit"]
