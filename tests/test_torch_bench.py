"""The port's benchmark (`ron_tensorflow_tpu_torch/bench.py`) and the CLI's
`bench`, on the CPU at tiny sizes (RON-tiny, batch 2, one timed iteration,
two latency samples): one JSON line whose keys are those of the JAX
`bench.py`'s record, read from that file's source (it imports JAX, so it is
not run), but its three baseline keys, every number finite and > 0. The
bench's (1, 1)-mesh train step is the one-process step, bit for bit. The
CLI's `bench` reaches `bench.main` with `--device`, raises without a card by
default, and its parser refuses unknown arguments."""

import contextlib
import io
import json
import math
from pathlib import Path

import pytest
import torch

from ron_tensorflow_tpu_torch import bench, cli
from ron_tensorflow_tpu_torch.config import TrainConfig, apply_overrides
from ron_tensorflow_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
TINY = dict(model="ron_tiny_vgg", batch=2, warmup=0, iters=1, train_batches=(2, 2), train_iters=1, lat_iters=2)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def printed(monkeypatch_module):
    monkeypatch_module.delenv("BENCH_CKPT", raising=False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        record = bench.main(device="cpu", **TINY)
    return out.getvalue(), record


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_one_json_line_with_the_jax_record_keys(printed):
    text, record = printed
    lines = text.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == record
    assert list(line) == bench.record_keys()
    assert bench.record_keys() == [k for k in bench.jax_record_keys() if k not in bench.OMITTED_JAX_KEYS]
    assert line["metric"] == "ron320_inference_images_per_sec_per_chip" and line["unit"] == "images/sec"


def test_every_number_finite_and_positive(printed):
    _, record = printed
    assert all(v is not None for v in record.values())
    for key in ("inference_runs_images_per_sec", "train_bs32_runs", "link_rtt_ms_p50_p90_before",
                "link_rtt_ms_p50_p90_after"):
        assert len(record[key]) == 2, key
    values = bench.record_numbers(list(record.values()))
    assert len(values) == 15
    assert all(math.isfinite(x) and x > 0 for x in values), record
    assert record["value"] == max(record["inference_runs_images_per_sec"])
    assert record["train_images_per_sec_bs32"] == max(record["train_bs32_runs"])
    assert record["latency_p90_ms"] >= record["latency_p50_ms"]


def test_latency_weights_and_baseline_name_their_sources(printed):
    _, record = printed
    assert record["latency_weights"] == "trained:e2e_parity_trained.npz@20000"
    assert not {"vs_baseline", "baseline_img_per_sec", "baseline_source"} & set(record)
    assert set(bench.OMITTED_JAX_KEYS) <= set(bench.jax_record_keys())


def test_bench_ckpt_must_name_a_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("BENCH_CKPT", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError, match="BENCH_CKPT"):
        bench.latency_state()


def test_mesh_1x1_step_is_the_one_process_step(tmp_path):
    """bench_train's (1, 1) mesh: the same losses and parameters after a
    step as without a mesh, from the same seeded init and batch."""
    results = []
    for i, mesh in enumerate(("[1, 1]", "null")):
        cfg = apply_overrides(TrainConfig(), ["model=ron_tiny_vgg", f"model_dir={tmp_path / str(i)}",
                                              "data.batch_size=2", "data.max_boxes=8",
                                              "optimizer.learning_rate_decay_type=fixed", f"mesh_shape={mesh}"])
        trainer = Trainer(cfg, device="cpu")
        assert (trainer.mesh is not None) == (mesh != "null")
        state, metrics = trainer.step(trainer.init_state(), bench.train_batch(2, "cpu"))
        results.append((metrics, {k: v.detach().clone() for k, v in state.params.items()}))
    (m1, p1), (m0, p0) = results
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m0.items()}
    assert all(torch.equal(p1[k], p0[k]) for k in p0)


def test_cli_bench_reaches_bench_main_with_the_device(monkeypatch):
    calls = []
    monkeypatch.setattr(bench, "main", lambda **kwargs: calls.append(kwargs))
    cli.main(["--device", "cpu", "bench"])
    assert calls == [{"device": "cpu"}]


def test_cli_bench_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["bench"])


def test_unknown_argument_fails_in_the_parser(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--iters", "3"])
    assert e.value.code == 2
    assert "unrecognized arguments: --iters 3" in capsys.readouterr().err


def test_module_entry_point_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    import subprocess
    import sys

    run = subprocess.run([sys.executable, "-m", "ron_tensorflow_tpu_torch.bench"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and run.stdout == ""
    assert "torch.cuda.is_available() is False" in run.stderr
