"""What every cell shares: the plan read from `BENCHMARK.json` and the
benchmark's data files, the spans and the profiler window of a traced
run, the metric readers, and the result line.

Everything that belongs to one configuration, traffic mix, entry or metric
sits in a file of its own, found by its name:

  BENCHMARK.json                      the cells, metrics and bounds
  ronbench/configs/<config>.json      sizes, weights, heads, limits (the `file` of each configuration)
  ronbench/traffic/<traffic>.json     the entry that drives it, batch, pool, scenes, warm-up
  ronbench/entries/<entry>.py         setup(), window(), check() of one way of driving the program
  ronbench/metrics/<metric>.py        read(ctx) -> number or None, one per metric

so a cell, a configuration, a traffic mix or a metric is added with new
files and entries alone.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "ron_tensorflow_tpu")
MARK_PREFIX = "ronbench."  # the names of the ranges the entries mark while profiling


@dataclasses.dataclass
class Plan:
    root: Path
    cell: dict
    config: dict
    traffic: dict
    entry: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def name(self) -> str:
        return self.cell["name"]

    def limit(self, check: str) -> float:
        """A check's limit: the traffic file's, else the configuration's."""
        for d in (self.traffic.get("limits", {}), self.config.get("limits", {})):
            if d.get(check) is not None:
                return float(d[check])
        raise KeyError(f"no limit for {check!r} in {self.name}'s traffic or configuration file")


def benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(path: Path) -> ModuleType:
    """A module from its file (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(f"ronbench_file_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(root, workload: str) -> Plan:
    """The plan of one cell, every file it names loaded."""
    root = Path(root)
    bench = benchmark(root)
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "ronbench" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    entry = load_module(root / "ronbench" / "entries" / f"{traffic['entry']}.py")
    return Plan(root, cell, config, traffic, entry,
                [m for m in bench["end_to_end"] if applies(m, workload)],
                [m for m in bench["per_layer"] if applies(m, workload)])


def cells(root) -> List[str]:
    return [c["name"] for c in benchmark(Path(root))["workloads"]]


def reader(root: Path, name: str) -> Callable:
    return load_module(Path(root) / "ronbench" / "metrics" / f"{name}.py").read


class Spans:
    """CUDA events at named points of each call, resolved after the window:
    `mark(point)` records one; `between(a, b)` gives the ms from each call's
    `a` to its `b`."""

    def __init__(self):
        self.calls: List[Dict[str, torch.cuda.Event]] = []

    def start(self):
        self.calls.append({})
        self.mark("call_start")

    def mark(self, point: str):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.calls[-1][point] = e

    def between(self, a: str, b: str) -> List[float]:
        torch.cuda.synchronize()
        return [c[a].elapsed_time(c[b]) for c in self.calls if a in c and b in c]


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    plan: Plan
    setup_s: float
    counters: dict
    spans: Optional[Spans] = None
    trace: Optional[dict] = None


def _ns(e, which: str) -> float:
    if which == "start":
        return e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1e3
    return e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1e3


LABELLED_GAPS = 300  # the longest idle gaps, each named; the rest summed under one name


def host_label(host, starts, t) -> str:
    """The innermost host event open at t: of those that started before it,
    the latest that has not ended (searched among the last few thousand)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 5000, 0) - 1, -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host: Python between calls into torch"


def summarize(prof) -> dict:
    """The profiler window in numbers: device intervals by name, busy and
    window seconds, the longest device operations and idle gaps (each gap
    named by the innermost host event open at its middle)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        kind = str(e.device_type()).split(".")[-1]
        if kind == "CUDA" and e.name().startswith(MARK_PREFIX):
            continue  # the benchmark's own ranges, as the profiler shows them on the device's timeline
        (dev if kind == "CUDA" else host).append((start, end, e.name()))
    if not dev:
        return {"kernels": {}, "busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    t0 = min(s for s, _, _ in dev + host)
    t1 = max(e for _, e, _ in dev + host)
    kernels: Dict[str, List[float]] = {}
    for s, e, n in dev:
        kernels.setdefault(n, []).append((e - s) / 1e9)
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [(t0, t0)] + [tuple(m) for m in merged] + [(t1, t1)]
    spans = sorted(((b - a, a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a), reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    for n, (length, a, b) in enumerate(spans):
        if n < LABELLED_GAPS:
            label = host_label(host, starts, (a + b) / 2)
        else:
            label = f"shorter gaps (each under {spans[LABELLED_GAPS - 1][0] / 1e3:.1f} us)"
        gaps[label] = gaps.get(label, 0.0) + length / 1e9
    ops = sorted(((n[:160], sum(v)) for n, v in kernels.items()), key=lambda x: -x[1])[:10]
    idle = sorted(((n[:160], v) for n, v in gaps.items()), key=lambda x: -x[1])[:10]
    return {"kernels": kernels, "busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9,
            "device_ops": [list(o) for o in ops], "idle_gaps": [list(g) for g in idle]}


def profile(fn: Callable) -> dict:
    """fn() under torch.profiler (host and device activity), summarized."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return summarize(prof)


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's or the JAX package's."""
    import sys

    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def run_cell(plan: Plan, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set-up, the window, the traced window where asked for, the check,
    and the metrics: the result line's fields (no chip look here)."""
    device = torch.device(device)
    print(f"ronbench: {plan.name}: {time.perf_counter() - t_start:.3f} s before set-up (imports)", file=sys.stderr)
    state = plan.entry.setup(plan, seed, device)
    gc.collect()
    gc.freeze()  # what set-up made stays out of the collector's scans in the window
    setup_s = time.perf_counter() - t_start
    spans = Spans() if trace else None
    counters = plan.entry.window(state, seconds, spans=spans)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = None
    if trace:
        summary = profile(lambda: plan.entry.window(state, plan.traffic["profile_seconds"], sample=False,
                                                    profiling=True))
    t_check = time.perf_counter()
    checks, found = plan.entry.check(state)
    counters.update(found)
    print(f"ronbench: {plan.name} seed {seed}: set-up {setup_s:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s, " + ", ".join(
        f"{k} {v!r}" for k, v in counters.items() if not isinstance(v, list)), file=sys.stderr)
    ctx = Context(plan, setup_s, counters, spans, summary)
    metrics = {}
    for m in plan.per_layer if trace else plan.end_to_end:
        value = reader(plan.root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks), "attempted": counters["attempted"],
           "failed": counters["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out


def cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    CUDA library into its own `_build/`, also inside the checkout)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        path = root / ".ronbench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
