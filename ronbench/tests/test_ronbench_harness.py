"""The harness: driven by files found by name, the result line the
contract asks for, and the imports the benchmark may not make."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ronbench import harness

import tiny

ROOT = tiny.ROOT
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def test_a_cell_config_and_metric_are_added_by_new_files_alone(tmp_path):
    root = tiny.tiny_root(tmp_path)  # copies of the repository's files, then new ones beside them
    (root / "ronbench" / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.counters['calls'] / ctx.counters['window_s']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "detect_img_per_s", "workloads": ["tiny.detect"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p.relative_to(ROOT) for p in (ROOT / "ronbench").rglob("*") if "__pycache__" not in p.parts}
    after = {p.relative_to(root) for p in (root / "ronbench").rglob("*") if "__pycache__" not in p.parts}
    for rel in before:  # no file the repository has was edited
        if (ROOT / rel).is_file():
            assert (ROOT / rel).read_bytes() == (root / rel).read_bytes(), rel
    assert before < after
    assert {"tiny.detect", "tiny.realtime", "tiny.train"} <= set(harness.cells(root))
    plan = harness.resolve(root, "tiny.detect")
    assert plan.config["name"] == "ron_tiny" and plan.traffic["entry"] == "detect"
    assert [m["name"] for m in plan.per_layer if m["name"] == "calls_per_s"]
    ctx = harness.Context(plan, 1.0, {"calls": 10, "window_s": 2.0})
    assert harness.reader(root, "calls_per_s")(ctx) == 5.0


def test_every_metric_and_cell_resolves_in_the_repository():
    bench = harness.benchmark(ROOT)
    for cell in harness.cells(ROOT):
        plan = harness.resolve(ROOT, cell)
        assert plan.end_to_end and plan.per_layer
        assert "setup_s" in [m["name"] for m in plan.end_to_end]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(ROOT, m["name"]))


def test_benchmark_json_keeps_to_the_contract():
    bench = harness.benchmark(ROOT)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("ronbench/")
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and name.match(w["name"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") and unit.match(m["unit"])
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells and name.match(m["name"]) and unit.match(m["unit"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.realtime", "tiny.train"])
def test_a_cpu_run_gives_the_contract_s_keys_in_order(tmp_path, cell):
    root = tiny.tiny_root(tmp_path)
    plan = harness.resolve(root, cell)
    out = harness.run_cell(plan, 2**31 + 5, 0.2, False, "cpu", 0.0)
    assert list(out) == RESULT_KEYS and set(out["device"]) == DEVICE_KEYS
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in plan.end_to_end}
    for check in out["checks"].values():
        assert set(check) == {"value", "limit"}


def imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def top(name: str) -> str:
    return name.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    forbidden = {"jax", "jaxlib", "flax", "ron_tensorflow_tpu"}
    files = [p for p in (ROOT / "ronbench").rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) > 20
    found = {(str(p.relative_to(ROOT)), m) for p in files for m in imports(p) if top(m) in forbidden}
    assert not found
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "ron_tensorflow_tpu")


def test_the_reference_imports_nothing_of_the_program():
    files = list((ROOT / "ronbench" / "reference").rglob("*.py"))
    assert files
    found = {(p.name, m) for p in files for m in imports(p)
             if top(m) in ("ron_tensorflow_tpu_torch", "ron_tensorflow_tpu") or top(m) == "ronbench"
             and not m.startswith("ronbench.reference")}
    assert not found


def test_the_runner_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    proc = subprocess.run([sys.executable, "-m", "ronbench.run", "--workload", "ron320.detect_b64_crowded",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_the_runner_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    """Only BENCHMARK.json and the files under `paths`: no program to run."""
    import shutil

    shutil.copytree(ROOT / "ronbench", tmp_path / "ronbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    plan = harness.resolve(tmp_path, "ron320.detect_b64_crowded")
    with pytest.raises(FileNotFoundError):  # the trained weights lie outside `paths`
        harness.run_cell(plan, 1, 0.1, False, "cpu", 0.0)
    proc = subprocess.run([sys.executable, "-m", "ronbench.run", "--workload", "ssd300.detect_b64", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ron_tensorflow_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "flaxen", sys)
    assert "ron_tensorflow_tpu_torch_like" not in harness.forbidden_modules()
    assert "flaxen" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax.core" in harness.forbidden_modules()


@pytest.mark.cuda
def test_a_tiny_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = tiny.tiny_root(tmp_path)
    out = harness.run_cell(harness.resolve(root, "tiny.detect"), 7, 0.5, True, "cuda", 0.0)
    assert out["correct"] is True and out["device"]["busy_s"] > 0
