"""A checkout-shaped copy of the benchmark with tiny cells, for the CPU tests."""

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]

TRAFFIC_FILES = {"detect": "detect_b64_crowded.json", "realtime": "realtime_b32_crowded.json",
                 "train": "train_b32_crowded.json"}
TINY_TRAFFIC = {"batch": 2, "pool_batches": 2, "fuse_block1": True, "warmup_calls": 1, "sample_passes": 2,
                "profile_seconds": 0.1}
# the tiny training cell runs its model in float32 (config `tiny32`), where the port meets the reference
# to rounding: these limits sit far below what the control and the faults read
TINY_TRAIN = {"batch": 4, "pool_batches": 3, "fuse_block1": False, "canvas": [96, 96], "profile_seconds": 0.1,
              "limits": {"loss_gap": 1e-4, "grad_norm_gap": 1e-4, "change_norm_gap": 0.01, "augment_faults": 0.0}}
ENTRIES = tuple(TRAFFIC_FILES)


def tiny_root(tmp: Path) -> Path:
    """tmp holding BENCHMARK.json and ronbench/ as the repository has them,
    plus a 64x64 RON configuration and tiny traffic for each entry, and
    cells `tiny.detect`, `tiny.realtime` and `tiny.train` over them."""
    shutil.copytree(ROOT / "ronbench", tmp / "ronbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a 64x64 RON for the CPU tests",
                             "file": "ronbench/tests/data/ron_tiny.json", "reduced": [], "why": "CPU tests"})
    tiny32 = json.loads((HERE / "data" / "ron_tiny.json").read_text())
    tiny32.update(name="ron_tiny32", dtype="float32")
    (tmp / "ronbench" / "tests" / "data" / "ron_tiny32.json").write_text(json.dumps(tiny32))
    bench["configs"].append({"name": "tiny32", "source": "the tiny RON in float32, for the CPU tests",
                             "file": "ronbench/tests/data/ron_tiny32.json", "reduced": [], "why": "CPU tests"})
    for entry in ENTRIES:
        base = json.loads((ROOT / "ronbench" / "traffic" / TRAFFIC_FILES[entry]).read_text())
        base.update(TINY_TRAIN if entry == "train" else TINY_TRAFFIC, entry=entry)
        (tmp / "ronbench" / "traffic" / f"tiny_{entry}.json").write_text(json.dumps(base))
        bench["workloads"].append({"name": f"tiny.{entry}", "config": "tiny32" if entry == "train" else "tiny",
                                   "traffic": f"tiny_{entry}", "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [f"tiny.{e}" for e in ENTRIES if any(w.startswith("ron320." + e)
                                                                   for w in m["workloads"])]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
