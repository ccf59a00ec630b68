"""The port's benchmark: the workload of the JAX package's `bench.py`, on
the card, as one JSON line with the keys of that script's record
(`bench.py:338-359`) but its three baseline keys (`OMITTED_JAX_KEYS`),
each measured under the JAX script's condition:

1. `value`, `inference_runs_images_per_sec`: batched inference, the
   `Detector` (forward, decode, gate, exact per-class top-k, K-A NMS) on
   bf16 RON-320 at batch 32 with block 1 through K-B, seeded weights,
   standard-normal inputs; two runs of 20 timed batches;
   `inference_images_per_sec_fast_knobs`: the same with `shared_top_k=1000`
   and `approx_top_k=True` (which selects exactly, so the key measures the
   preselection alone);
2. `train_images_per_sec_bs14`, `_bs32`, `train_bs32_runs`: `Trainer.step`
   (augmentation, encode, forward, backward, update) on one synthetic batch,
   50 timed steps;
3. `latency_p50_ms`, `_p90_ms`: batch-1 calls of the realtime head (K-C)
   on whitened noise, host pixels in, detections back on the host;
   `latency_pipelined_ms`: the same calls back to back on pixels already on
   the device, one wait, total / 50; `latency_weights` names the weights;
4. `link_rtt_ms_p50_p90_before`, `_after`: a 4-byte round trip to the
   device, before and after the rest.

Times are on the host clock, each window closed by one wait for the
device; the numbers are printed unrounded. `main(device="cuda")` raises
without a card; a CPU run (`device="cpu"`, small sizes through the
arguments) runs the same code with the kernels' plain versions and says
nothing about the card. Nothing is caught: a failure anywhere raises (the
JAX script prints null for a failed extra instead).

The JAX record's `vs_baseline`, `baseline_img_per_sec` and
`baseline_source` are left out: they divide by the reference's TF graph
measured on the CPU of another host, which is no speed-up of the card over
anything.

  python -m ron_tensorflow_tpu_torch.cli bench
  python -m ron_tensorflow_tpu_torch.bench
"""

from __future__ import annotations

import ast
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import resolve_device

REPO = Path(__file__).resolve().parent.parent
TRAINED_FIXTURE = REPO / "tests" / "fixtures" / "e2e_parity_trained.npz"

MODEL = "ron_320_vgg"
BATCH = 32
WARMUP = 3
ITERS = 20
LAT_ITERS = 50
TRAIN_BATCHES = (14, 32)
TRAIN_ITERS = 50


def jax_record_keys() -> list:
    """The keys of the record that the JAX package's `bench.py` prints, in
    order, read from its source (it imports JAX: it is not run)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "record" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no `record = {...}` in bench.py")


OMITTED_JAX_KEYS = ("vs_baseline", "baseline_img_per_sec", "baseline_source")


def record_keys() -> list:
    """The keys this benchmark prints, in order: the JAX record's but `OMITTED_JAX_KEYS`."""
    return [k for k in jax_record_keys() if k not in OMITTED_JAX_KEYS]


def record_numbers(value) -> list:
    """Every number in a record's values, lists flattened."""
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in record_numbers(v)]
    return [value] if isinstance(value, (int, float)) and not isinstance(value, bool) else []


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe_link_rtt(device, iters=40, warmup=3):
    """(p50, p90) ms of a 4-byte tensor sent to the device and read back."""
    x = np.zeros((1,), np.float32)
    for _ in range(warmup):
        torch.from_numpy(x).to(device).cpu()
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        torch.from_numpy(x).to(device).cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 90))


def seeded_network(name: str, dtype, fuse_block1: bool = False, seed: int = 0):
    """(model, spec) with flax's initializers drawn from `seed`."""
    from .models import get_network
    from .models.layers import init_like_flax_

    model, spec = get_network(name, dtype=dtype, fuse_block1=fuse_block1)
    init_like_flax_(model, torch.Generator().manual_seed(seed))
    return model, spec


def bench_inference(device="cuda", shared_top_k=0, approx_top_k=False, model=MODEL, batch=BATCH,
                    warmup=WARMUP, iters=ITERS) -> float:
    """Images/s of the Detector's batched calls (JAX `bench.py:88-137`):
    bf16, block 1 through K-B on the card, the default `DetectionConfig`
    (K-A) but for the two knobs; one call, `warmup` calls, then `iters`
    timed ones closed by one synchronize."""
    from .inference.detector import DetectionConfig, Detector

    device = resolve_device(device)
    net, spec = seeded_network(model, torch.bfloat16, fuse_block1=device.type == "cuda")
    det = Detector(net, spec, DetectionConfig(shared_top_k=shared_top_k, approx_top_k=approx_top_k), device=device)
    images = torch.randn((batch, *spec.img_shape, 3), generator=torch.Generator().manual_seed(0)).to(device)
    det(images)
    for _ in range(warmup):
        det(images)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        det(images)
    synchronize(device)
    return batch * iters / (time.perf_counter() - t0)


def train_batch(bs: int, device) -> dict:
    """JAX `bench.py:172-181`'s synthetic batch: uint8 noise on the 512
    canvas, one box of label 3 and seven padding rows per image."""
    rng = np.random.default_rng(0)
    host = {
        "image01": rng.integers(0, 255, (bs, 512, 512, 3), np.uint8),
        "gt_boxes": np.tile(np.array([[[0.2, 0.2, 0.7, 0.7]] + [[0.0] * 4] * 7], np.float32), (bs, 1, 1)),
        "gt_labels": np.tile(np.array([[3] + [0] * 7], np.int32), (bs, 1)),
        "gt_valid": np.tile(np.array([[True] + [False] * 7]), (bs, 1)),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def bench_train(bs: int, device="cuda", model=MODEL, warmup=WARMUP, iters=TRAIN_ITERS) -> float:
    """Images/s of `Trainer.step` at batch `bs` (JAX `bench.py:140-199`),
    with JAX's overrides; `fuse_block1` keeps its default (off), as there.
    The (1, 1) mesh in one process is the one-process step: no group, the
    batch's rows are the whole batch. The model directory is a fresh
    temporary one, since a Trainer resumes from any checkpoint there."""
    from .config import TrainConfig, apply_overrides
    from .train.trainer import Trainer

    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as model_dir:
        cfg = apply_overrides(TrainConfig(), [
            f"model={model}",
            f"model_dir={model_dir}",
            f"data.batch_size={bs}",
            "data.max_boxes=8",
            "bfloat16=true",
            "mesh_shape=[1, 1]",
            "optimizer.learning_rate_decay_type=fixed",
        ])
        trainer = Trainer(cfg, device=device)
        state = trainer.init_state()
        batch = train_batch(bs, device)
        for _ in range(1 + warmup):
            state, metrics = trainer.step(state, batch)
        float(metrics["loss/total"])
        t0 = time.perf_counter()
        for _ in range(iters):
            state, metrics = trainer.step(state, batch)
        float(metrics["loss/total"])
        return bs * iters / (time.perf_counter() - t0)


def latency_state():
    """Weights of the latency run, in JAX `bench.py:202-263`'s order: the
    port checkpoint directory named by `BENCH_CKPT`; else the trained
    RON-320 packed in the repository's parity fixture; else the seeded
    init. -> (state_dict or None, source). JAX's third source, a glob of
    its rehearsal runs' model directories, names orbax checkpoints, which
    the port does not read: left out."""
    from .weights import from_jax_params, load_trained_fixture

    ckpt = os.environ.get("BENCH_CKPT", "")
    if ckpt:
        from .train.checkpoint import CheckpointManager

        if not os.path.isdir(ckpt):
            raise FileNotFoundError(f"BENCH_CKPT={ckpt!r} is not a checkpoint directory")
        variables, step = CheckpointManager(ckpt).restore_eval()
        return {**variables["params"], **variables["batch_stats"]}, f"trained:{ckpt}@{step}"
    if TRAINED_FIXTURE.exists():
        with np.load(TRAINED_FIXTURE, allow_pickle=False) as fx:
            step = int(fx["weights_step"]) if "weights_step" in fx.files else -1
        return from_jax_params(*load_trained_fixture(str(TRAINED_FIXTURE))), f"trained:{TRAINED_FIXTURE.name}@{step}"
    return None, "random-init"


def latency_ms(run, inputs, device, warmup=WARMUP):
    """Batch-1 latency of `run` as JAX `bench.py:290-324` defines it:
    `warmup` calls, then p50 and p90 ms of one synchronous call on each of
    `inputs` (host pixels in, detections copied back to the host), and
    pipelined ms: every input staged on `device` first, the calls
    dispatched back to back, one fetch of the last, total / len(inputs).
    -> (p50, p90, pipelined)."""

    def fetch(out):
        return [t.cpu() for t in out]

    for _ in range(warmup):
        fetch(run(inputs[0]))
    lat = []
    for x in inputs:
        t0 = time.perf_counter()
        fetch(run(x))
        lat.append((time.perf_counter() - t0) * 1e3)
    staged = [torch.as_tensor(x, device=device) for x in inputs]
    fetch(run(staged[0]))
    t0 = time.perf_counter()
    for x in staged:
        out = run(x)
    fetch(out)
    pipelined = (time.perf_counter() - t0) * 1e3 / len(inputs)
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 90)), pipelined


def bench_latency(device="cuda", model=MODEL, iters=LAT_ITERS, warmup=WARMUP):
    """Batch-1 latency of the realtime head (JAX `bench.py:266-324`): bf16,
    block 1 unfused, `RealtimeConfig.for_spec` (K-C), whitened uint8 noise.
    -> (p50 ms, p90 ms, pipelined ms, weights source)."""
    from .data.preprocess import whiten_np
    from .inference.detector import RealtimeConfig, RealtimeDetector

    device = resolve_device(device)
    net, spec = seeded_network(model, torch.bfloat16)
    state, source = latency_state()
    if state is not None:
        net.load_state_dict(state, strict=True)
    rng = np.random.default_rng(0)
    images = whiten_np(rng.integers(0, 256, (iters, 1, *spec.img_shape, 3)).astype(np.float32) / 255.0)
    rt = RealtimeDetector(net, spec, RealtimeConfig.for_spec(spec), device=device)
    return (*latency_ms(rt, list(images), device, warmup), source)


def main(device="cuda", model=MODEL, batch=BATCH, warmup=WARMUP, iters=ITERS, train_batches=TRAIN_BATCHES,
         train_iters=TRAIN_ITERS, lat_iters=LAT_ITERS) -> dict:
    """Run every measurement in the JAX script's order, print the record as
    one JSON line and return it. `train_batches` are the batches of the
    `_bs14` and `_bs32` keys."""
    device = resolve_device(device)
    rtt_before = probe_link_rtt(device)
    runs = [bench_inference(device, model=model, batch=batch, warmup=warmup, iters=iters) for _ in range(2)]
    fast = bench_inference(device, shared_top_k=1000, approx_top_k=True, model=model, batch=batch, warmup=warmup,
                           iters=iters)
    small, large = train_batches
    train_small = bench_train(small, device, model, warmup, train_iters)
    train_runs = [bench_train(large, device, model, warmup, train_iters) for _ in range(2)]
    p50, p90, pipelined, weights = bench_latency(device, model, lat_iters, warmup)
    record = {
        "metric": "ron320_inference_images_per_sec_per_chip",
        "value": max(runs),
        "unit": "images/sec",
        "inference_runs_images_per_sec": runs,
        "inference_images_per_sec_fast_knobs": fast,
        "link_rtt_ms_p50_p90_before": list(rtt_before),
        "link_rtt_ms_p50_p90_after": list(probe_link_rtt(device)),
        "train_images_per_sec_bs14": train_small,
        "train_images_per_sec_bs32": max(train_runs),
        "train_bs32_runs": train_runs,
        "latency_p50_ms": p50,
        "latency_p90_ms": p90,
        "latency_pipelined_ms": pipelined,
        "latency_weights": weights,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
