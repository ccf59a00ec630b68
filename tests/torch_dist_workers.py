"""Rank functions of the port's multi-process tests (gloo on the CPU).

`ron_tensorflow_tpu_torch.parallel.testing.run_ranks` runs each in fresh
processes, `fn(rank, world, port, **kwargs)`; they import torch, numpy and
the port only (no JAX). Each bounds its process group's init and
collectives with `TIMEOUT`, and the parent bounds the whole run.
"""

from __future__ import annotations

import datetime
import hashlib

import numpy as np
import torch

from ron_tensorflow_tpu_torch.losses.ron import RonLossConfig
from ron_tensorflow_tpu_torch.losses.ssd import SsdLossConfig
from ron_tensorflow_tpu_torch.models import get_network, layers, shard_model
from ron_tensorflow_tpu_torch.ops.encode import TargetEncoder
from ron_tensorflow_tpu_torch.parallel import host_local_to_global, initialize_distributed, make_mesh, sharded_names
from ron_tensorflow_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from ron_tensorflow_tpu_torch.train.state import create_train_state, gathered_state_dict, make_train_step

TIMEOUT = datetime.timedelta(seconds=150)
OPT = dict(optimizer="momentum", learning_rate=1e-5, learning_rate_decay_type="fixed", weight_decay=5e-4)
EMA = 0.9
MATCH = (0.5, 0.3)  # the encoder's positive and ignore thresholds


def start(rank, world, port, mesh_shape):
    """Two torch threads, the gloo group and the mesh."""
    torch.set_num_threads(2)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cpu", timeout=TIMEOUT)
    return make_mesh(tuple(mesh_shape))


def tiny_batch(seed=0, b=4, g=4, canvas=64):
    """b images of the tiny RON with up to g gts each (numpy), each image
    its own contrast and brightness (tests/test_torch_train.py's batch)."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, g, 4), np.float32)
    for i in range(b):
        for j in range(g):
            y0, x0 = rng.uniform(0.0, 0.5, 2)
            h, w = rng.uniform(0.2, 0.5, 2)
            boxes[i, j] = (y0, x0, y0 + h, x0 + w)
    return {
        "image": (rng.uniform(-128, 128, (b, canvas, canvas, 3)) * rng.uniform(0.1, 1.0, (b, 1, 1, 1))
                  + rng.uniform(-80, 80, (b, 1, 1, 3))).astype(np.float32),
        "gt_labels": rng.integers(1, 21, (b, g)).astype(np.int32),
        "gt_boxes": boxes,
        "gt_valid": np.arange(g)[None, :] < rng.integers(1, g + 1, (b, 1)),
    }


def loss_draws(seed, b, n):
    """The RON loss's two uniform draws of a global batch, [2, b, n]."""
    return torch.as_tensor(np.random.default_rng(seed).uniform(size=(2, b, n)).astype(np.float32))


def loss_config(name):
    return SsdLossConfig(match_threshold=MATCH[0]) if name == "ssd" else RonLossConfig()


def digest(tensors) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def tiny_steps(weights, mesh, loss, steps, clip, batches, draws, dtype=torch.float32):
    """`steps` train steps of the tiny RON from `weights` (a state_dict
    file) on the global `batches[i]` with `draws[i]`; on `mesh` (this rank's
    rows) or in one process (mesh None). Returns (metrics of each step, the
    whole state: params, batch stats, EMA, and the names sharded on 'model')."""
    model, spec = get_network("ron_tiny_vgg", dtype=dtype)
    model.load_state_dict(torch.load(weights, weights_only=True))
    enc = TargetEncoder(spec.anchor_layout(), spec.img_shape, *MATCH)
    tx = make_optimizer(OptimizerConfig(**OPT, clip_global_norm=clip), model)
    if mesh is not None:
        shard_model(model, mesh)
    state = create_train_state(model, tx, ema=True)
    step = make_train_step(model, enc, tx, loss_config(loss), EMA, mesh)
    metrics = []
    for batch, d in zip(batches, draws):
        if mesh is not None:
            b = batch["image"].shape[0] // mesh.data_size
            rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
            batch = host_local_to_global({k: v[rows] for k, v in batch.items()}, mesh)
        else:
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        state, m = step(state, batch, draws=d)
        metrics.append({k: float(v) for k, v in m.items()})
    sharded = sharded_names(model, mesh) if mesh is not None else {}
    whole = gathered_state_dict(state, mesh, sharded) if mesh is not None else state.state_dict()
    return metrics, {k: whole[k] for k in ("params", "batch_stats", "ema_params")}, sorted(k for k, v in sharded.items()
                                                                                         if v)


def rel_errors(got, ref):
    """{name: max |got - ref| / max |ref|} over two tensor dicts."""
    return {k: float((got[k].double() - ref[k].double()).abs().max() / max(float(ref[k].abs().max()), 1e-30))
            for k in ref}


def train_step_worker(rank, world, port, weights, mesh_shape, loss="ron", steps=1, clip=0.0, batch=4,
                      draws_file=None, return_state=False, dtype="float32"):
    """The distributed steps; rank 0 also runs the one-process steps on the
    same global batches and draws and returns the largest relative errors.
    Every rank returns a digest of its gathered state. `draws_file`: the
    steps' loss draws (a list saved with torch.save), else seeded ones."""
    mesh = start(rank, world, port, mesh_shape)
    n = get_network("ron_tiny_vgg")[1].anchor_layout().num_anchors
    batches = [tiny_batch(seed=i, b=batch) for i in range(steps)]
    draws = (torch.load(draws_file) if draws_file else
             [loss_draws(100 + i, batch, n) for i in range(steps)])
    dtype = getattr(torch, dtype)
    metrics, whole, sharded = tiny_steps(weights, mesh, loss, steps, clip, batches, draws, dtype)
    out = {"metrics": metrics, "digest": digest({f"{p}/{k}": t for p in whole for k, t in whole[p].items()}),
           "sharded": sharded}
    if rank == 0:
        ref_metrics, ref, _ = tiny_steps(weights, None, loss, steps, clip, batches, draws, dtype)
        out["ref_metrics"] = ref_metrics
        out["state_errors"] = {p: rel_errors(whole[p], ref[p]) for p in ref}
        if return_state:
            out["state"] = whole
    return out


def sync_bn_worker(rank, world, port, seed=0, features=6):
    """A train-mode BatchNorm over 2 data ranks: this rank's rows of a
    seeded [4, C, 5, 5] batch; returns its output, the input's and the
    parameters' gradients under a seeded output gradient, and the running
    statistics."""
    mesh = start(rank, world, port, (world, 1))
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(1.0, 2.0, (4, features, 5, 5)))
    gy = torch.as_tensor(rng.normal(0.0, 1.0, (4, features, 5, 5)))
    bn = layers.BatchNorm(features).double()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, features)))
        bn.bias.copy_(torch.as_tensor(rng.normal(0.0, 0.1, features)))
    bn.data_group = mesh.data_group
    b = 4 // world
    xl = x[rank * b:(rank + 1) * b].clone().requires_grad_(True)
    y = bn(xl, train=True)
    (y * gy[rank * b:(rank + 1) * b]).sum().backward()
    return {"y": y.detach(), "gx": xl.grad, "gw": bn.weight.grad, "gb": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def ssd_loss_worker(rank, world, port, seed=0, b=4, n=300, c=21):
    """The SSD loss of this rank's rows of seeded logits and targets:
    (loss share, metrics, the gradient of the logits and locations)."""
    from ron_tensorflow_tpu_torch.losses.ssd import ssd_losses

    mesh = start(rank, world, port, (world, 1))
    logits, locs, labels, glocs, scores = ssd_inputs(seed, b, n, c)
    rows = slice(rank * (b // world), (rank + 1) * (b // world))
    lg, lc = logits[rows].clone().requires_grad_(True), locs[rows].clone().requires_grad_(True)
    total, metrics = ssd_losses(lg, lc, labels[rows], glocs[rows], scores[rows], SsdLossConfig(),
                                group=mesh.data_group)
    total.backward()
    return {"total": float(total.detach()), "metrics": {k: float(v) for k, v in metrics.items()},
            "g_logits": lg.grad, "g_locs": lc.grad}


def ssd_inputs(seed, b, n, c):
    """Seeded SSD loss inputs: logits, locations, labels, gt locations and
    matched IoU scores (about 5% positives, 5% ignored)."""
    rng = np.random.default_rng(seed)
    logits = torch.as_tensor(rng.normal(0.0, 2.0, (b, n, c)).astype(np.float32))
    locs = torch.as_tensor(rng.normal(0.0, 1.0, (b, n, 4)).astype(np.float32))
    scores = rng.uniform(0.0, 0.5, (b, n))
    scores[rng.uniform(size=(b, n)) < 0.05] = 0.8
    scores[rng.uniform(size=(b, n)) < 0.05] = -1.0
    labels = np.where(scores > 0.5, rng.integers(1, c, (b, n)), 0).astype(np.int64)
    glocs = torch.as_tensor(rng.normal(0.0, 1.0, (b, n, 4)).astype(np.float32))
    return logits, locs, torch.as_tensor(labels), glocs, torch.as_tensor(scores.astype(np.float32))


def mesh_worker(rank, world, port):
    """A (2, 2) mesh's groups, gather_channels' gradient, and make_mesh's
    errors, on 4 ranks."""
    from ron_tensorflow_tpu_torch.parallel.collectives import all_gather_rows, gather_channels

    mesh = start(rank, world, port, (2, 2))
    me = torch.tensor([float(rank)])
    out = {"coords": (mesh.data_index, mesh.model_index),
           "data_ranks": all_gather_rows(me, mesh.data_group).tolist(),
           "model_ranks": all_gather_rows(me, mesh.model_group).tolist()}
    # gather_channels: the whole tensor forward; backward, this rank's slice of the gradient
    x = torch.full((1, 2, 1, 1), float(rank), requires_grad=True)
    w = torch.arange(4.0).reshape(1, 4, 1, 1)
    y = gather_channels(x, mesh.model_group)
    (y * w).sum().backward()
    out["gathered"], out["grad"] = y.detach().flatten().tolist(), x.grad.flatten().tolist()
    errors = []
    for shape in ((4, 2), (1, 2)):
        try:
            make_mesh(shape)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


EVAL_DET = dict(select_threshold=0.01, objectness_threshold=0.0, top_k=64, keep_top_k=16)


def eval_batches(gts, n_batches=3, b=4, seed=0):
    """Seeded uint8 images of the tiny RON with the given gts
    ([n_batches * b, G] labels and [.., G, 4] boxes), the last batch's last
    row a padding row."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        rows = slice(i * b, (i + 1) * b)
        valid = np.ones((b,), bool)
        if i == n_batches - 1:
            valid[-1] = False
        out.append({"image": rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8), "gt_labels": gts["labels"][rows],
                    "gt_boxes": gts["boxes"][rows], "gt_difficult": np.zeros_like(gts["labels"][rows]),
                    "sample_valid": valid})
    return out


def tiny_evaluator(weights, mesh):
    from ron_tensorflow_tpu_torch.eval import StreamingEvaluator
    from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig

    model, spec = get_network("ron_tiny_vgg")
    model.load_state_dict(torch.load(weights, weights_only=True))
    return StreamingEvaluator(model, spec, DetectionConfig(**EVAL_DET), device="cpu", loss_config=RonLossConfig(),
                              mesh=mesh)


def evaluation(ev, batches):
    """(mAP07, mAP12, APs, stats, {class: (n_gt, scores, tp, fp)}) of a run."""
    map07, map12, aps, stats = ev.run(iter(batches), log_every=0)
    classes = None
    if ev.primary:
        classes = {c: (ev.accumulator.n_gt[c], *ev.accumulator.class_arrays(c)) for c in range(1, 21)}
    return map07, map12, aps, stats, classes


def eval_worker(rank, world, port, weights, gts_file):
    """The streaming evaluator on a (world, 1) mesh over `eval_batches`."""
    mesh = start(rank, world, port, (world, 1))
    gts = dict(np.load(gts_file))
    return evaluation(tiny_evaluator(weights, mesh), eval_batches(gts))


def trainer_worker(rank, world, port, overrides, max_steps):
    """`Trainer.train` of the config built from `overrides` in this rank, to
    `max_steps`; returns the step, a digest of the whole (gathered)
    parameters and BN statistics, and this rank's saved input position."""
    import json
    import os

    from ron_tensorflow_tpu_torch.config import TrainConfig, apply_overrides
    from ron_tensorflow_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(2)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cpu", timeout=TIMEOUT)
    cfg = apply_overrides(TrainConfig(), overrides)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.train(max_steps=max_steps)
    whole = gathered_state_dict(state, trainer.mesh, trainer.sharded)
    path = os.path.join(cfg.model_dir, f"input_state_{rank}.json")
    return {"step": state.step, "digest": digest({**whole["params"], **whole["batch_stats"]}),
            "input_state": json.loads(json.loads(open(path).read())) if os.path.exists(path) else None}
