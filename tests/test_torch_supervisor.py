"""The port's supervisor (`ron_tensorflow_tpu_torch/tools/train_supervised.py`),
on the CPU.

- Every case of tests/test_supervisor.py, run against the port's tool: that
  module's tests are called with its SUPERVISOR path pointed at the port's
  script (a stub interpreter answers their probes, as there).
- The port's probe needs CUDA: here it reports "not ready" within its
  timeout, and the supervisor keeps waiting after an exit 75 instead of
  taking the CPU as ready.
- The RSS contract end to end: the port's CLI `train` of RON-tiny on the
  CPU (Grain input, three steps) under the supervisor with
  max_host_rss_gb=1e-6 exits 75 after each of steps 1, 2 and 3 and is
  relaunched each time (4 launches); its checkpoint at step 3 (parameters,
  statistics, optimizer state) and each step's loss and record keys equal
  those of one uninterrupted run exactly (the CPU is deterministic).
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from ron_tensorflow_tpu_torch.tools import train_supervised
from ron_tensorflow_tpu_torch.tools.synthetic_data import make_dataset
from ron_tensorflow_tpu_torch.train.checkpoint import CheckpointManager

REPO = Path(__file__).resolve().parent.parent
PORT_SUPERVISOR = REPO / "ron_tensorflow_tpu_torch" / "tools" / "train_supervised.py"
STEPS = 3


def jax_supervisor_tests():
    spec = importlib.util.spec_from_file_location("jax_supervisor_tests", REPO / "tests" / "test_supervisor.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_TESTS = jax_supervisor_tests()
CASES = sorted(name for name in vars(JAX_TESTS) if name.startswith("test_"))


def test_every_case_is_run():
    assert CASES == ["test_clean_exit_passes_through", "test_crash_budget_exhausts", "test_no_command_errors",
                     "test_tempfail_restarts_until_done"]


@pytest.mark.parametrize("case", CASES)
def test_jax_supervisor_cases_on_the_port(case, tmp_path, monkeypatch):
    monkeypatch.setattr(JAX_TESTS, "SUPERVISOR", str(PORT_SUPERVISOR))
    fn = getattr(JAX_TESTS, case)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[: fn.__code__.co_argcount] else fn()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the probe succeeds there")
def test_cuda_probe_is_not_ready_without_a_card():
    t0 = time.time()
    assert not train_supervised.device_ready(timeout=120.0, python=sys.executable)
    assert time.time() - t0 < 60


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the probe succeeds there")
def test_no_relaunch_until_the_card_answers(tmp_path):
    marker = tmp_path / "count"
    script = f"import sys; p = {str(marker)!r}; open(p, 'a').write('x'); sys.exit(75)"
    proc = subprocess.Popen([sys.executable, str(PORT_SUPERVISOR), "--probe-interval", "0.1", "--probe-timeout", "60",
                             "--", sys.executable, "-c", script], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    deadline = time.time() + 60
    out = ""
    try:
        while time.time() < deadline and out.count("probe hung/failed") < 2:
            out += proc.stdout.readline()
    finally:
        proc.kill()
        out += proc.communicate()[0]
    assert out.count("probe hung/failed") >= 2, out
    assert marker.read_text() == "x" and "launch #2" not in out


def shim_python(tmp_path):
    """An interpreter for the probe that answers ready at once."""
    shim = tmp_path / "shim.py"
    shim.write_text("print('probe-ok')\n")
    wrapper = tmp_path / "fakepython"
    wrapper.write_text(f"#!/bin/sh\nexec {sys.executable} {shim} \"$@\"\n")
    wrapper.chmod(0o755)
    return str(wrapper)


def train_cmd(model_dir, records, *extra):
    return [sys.executable, "-m", "ron_tensorflow_tpu_torch.cli", "--device", "cpu", "train",
            "--model-dir", str(model_dir), "--dataset-dir", str(records), "model=ron_tiny_vgg",
            "data.file_pattern=synth_train_*.tfrecord", "data.use_grain=true", "data.batch_size=2",
            "data.working_shape=[64, 64]", "bfloat16=false", f"max_steps={STEPS}", "log_every_steps=1",
            "tensorboard=false", "max_to_keep=1", *extra]


def run_cmd(cmd):
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def step_log(model_dir):
    losses = [(r["step"], r["loss/total"]) for r in map(json.loads, open(model_dir / "metrics.jsonl"))]
    keys = [(r["step"], r["record_keys"]) for r in map(json.loads, open(model_dir / "input_keys.jsonl"))]
    return losses, keys


def test_rss_restarts_under_the_supervisor_equal_an_unbroken_run(tmp_path):
    records = make_dataset(str(tmp_path / "records"), n_train=8, n_test=1, canvas=64)
    sup, ref = tmp_path / "supervised", tmp_path / "unbroken"
    out = run_cmd([sys.executable, str(PORT_SUPERVISOR), "--probe-interval", "0.1", "--python", shim_python(tmp_path),
                   "--", *train_cmd(sup, records, "max_host_rss_gb=1e-6")])
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert out.stdout.count("[supervisor] launch #") == STEPS + 1
    assert out.stdout.count("EX_TEMPFAIL after") == STEPS and "run completed" in out.stdout
    assert out.stderr.count("exiting 75 (EX_TEMPFAIL)") + out.stdout.count("exiting 75 (EX_TEMPFAIL)") == STEPS
    done = run_cmd(train_cmd(ref, records))
    assert done.returncode == 0, done.stderr[-4000:]
    assert CheckpointManager(str(sup)).all_steps() == CheckpointManager(str(ref)).all_steps() == [STEPS]
    got, want = (CheckpointManager(str(d))._load(STEPS)[0] for d in (sup, ref))
    assert got.keys() == want.keys()
    flat_got, flat_want = _flatten(got), _flatten(want)
    assert flat_got.keys() == flat_want.keys() and flat_got
    for k, v in flat_want.items():
        assert torch.equal(flat_got[k], v) if torch.is_tensor(v) else flat_got[k] == v, k
    losses, keys = step_log(sup)
    assert (losses, keys) == step_log(ref)
    assert [s for s, _ in keys] == list(range(1, STEPS + 1)) and len({tuple(k) for _, k in keys}) == STEPS


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix: tree}
