"""Training: the port's `Trainer.step` (augmentation, target encoding,
forward in train mode, loss, backward, momentum update) at the traffic's
batch, steps back to back on a pool of crowded batches on the device.

Set-up draws `pool_batches` x `batch` scenes from the seed on the
`canvas` with their boxes (up to `max_boxes` a scene), as the port's input
pipeline hands the Trainer uint8 working canvases, and puts them on the
device; builds the Trainer with the configuration's training settings and
the seeded weights (flax's initializers), and drives that one state
through its first `first_steps` steps, each on another pool batch, through
the call the window makes: they are the steps the check compares, and the
warm-up. For them it keeps the parameters before, the optimizer's
momentum after the first step, the parameters after the last, each loss,
each step's augmented batch (the program's) and its generator's state
after the augmentation (where the loss draws its negatives).

The window goes on stepping through the pool; the host waits for step k
only after it has dispatched step k + 1, and the window ends on the wait
for the last step's update. Every step counts, over the whole time.

The check frees the program and runs the reference's steps in float32
from the same weights on the program's augmented batches and the same
draws (`reference.train`); it compares each step's loss, the first step's
gradient norm of each parameter (the momentum after one step less the
weight decay) and each parameter's change over the steps. The
augmentation, which the reference follows and does not redo, is checked
by itself against its input (`augment_faults`).
"""

from __future__ import annotations

import statistics
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from ronbench import scenes
from ronbench import weights as W
from ronbench.program import Stages, full_f32, marker
from ronbench.reference import nets, postprocess
from ronbench.reference import train as ref_train


def gts(objects, max_boxes: int):
    """Scenes' objects -> (labels [n, G] int64, boxes [n, G, 4] (ymin, xmin, ymax, xmax), valid [n, G])."""
    n = len(objects)
    labels, boxes, valid = np.zeros((n, max_boxes), np.int64), np.zeros((n, max_boxes, 4), np.float32), \
        np.zeros((n, max_boxes), bool)
    for i, obj in enumerate(objects):
        for j, (label, box) in enumerate(obj[:max_boxes]):
            labels[i, j], boxes[i, j], valid[i, j] = label, box, True
    return labels, boxes, valid


def setup(plan, seed: int, device: torch.device):
    from ron_tensorflow_tpu_torch.config import DataConfig, TrainConfig
    from ron_tensorflow_tpu_torch.train.optimizer import OptimizerConfig
    from ron_tensorflow_tpu_torch.train.state import create_train_state
    from ron_tensorflow_tpu_torch.train.trainer import Trainer

    cfg, tr, stage = plan.config, plan.traffic, Stages()
    (h, w), b, p = tr["canvas"], tr["batch"], tr["pool_batches"]
    pixels, objects = scenes.draw_pool(seed, b * p, h, w, tr["scenes"])
    labels, boxes, valid = gts(objects, tr["max_boxes"])
    stage("scenes")
    on = lambda a: torch.from_numpy(a).to(device).reshape(p, b, *a.shape[1:])  # noqa: E731
    pool = {"image01": on(pixels), "gt_boxes": on(boxes), "gt_labels": on(labels), "gt_valid": on(valid)}
    batches = [{k: v[j] for k, v in pool.items()} for j in range(p)]
    weights = W.load({**cfg, "weights": tr.get("weights", cfg["weights"])}, seed, device, plan.root)
    stage("weights")
    model_dir = tempfile.TemporaryDirectory(prefix="ronbench-train-")  # the Trainer's checkpoint directory, unused
    opt = cfg["optimizer"]
    config = TrainConfig(model=cfg["network"], model_dir=model_dir.name, seed=seed, tensorboard=False,
                         bfloat16=cfg["dtype"] == "bfloat16", fuse_block1=tr["fuse_block1"],
                         data=DataConfig(batch_size=b, working_shape=tuple(tr["canvas"]), max_boxes=tr["max_boxes"]),
                         optimizer=OptimizerConfig(learning_rate=opt["learning_rate"], momentum=opt["momentum"],
                                                   weight_decay=opt["weight_decay"]))
    trainer = Trainer(config, device=device)
    trainer.model.to(device)
    trainer.model.load_state_dict(weights, strict=True)
    ts = create_train_state(trainer.model, trainer.tx)
    stage("model")
    state = SimpleNamespace(plan=plan, device=device, batches=batches, weights=weights, program=trainer, ts=ts,
                            next=0, model_dir=model_dir, control=False)
    state.first = first_steps(state, tr["first_steps"], opt["weight_decay"])
    stage("first steps")
    stage.report(plan.name)
    return state


def first_steps(state, n: int, weight_decay: float) -> dict:
    """The first n steps through `Trainer.step`, and what the check reads of them."""
    trainer, ts = state.program, state.ts
    cpu = lambda d: {k: v.detach().float().cpu().clone() for k, v in d.items()}  # noqa: E731
    before = cpu(ts.params)
    kept = []

    def augment(batch, generator):
        out = type(trainer).augment(trainer, batch, generator)
        kept.append(({k: v.detach().cpu().clone() for k, v in out.items()}, generator.get_state()))
        return out

    trainer.augment = augment  # the instance's, in front of the class's, for these steps only
    losses, momentum = [], None
    try:
        for k in range(n):
            ts, metrics = trainer.step(ts, state.batches[state.next % len(state.batches)])
            state.next += 1
            losses.append(float(metrics["loss/total"]))
            if momentum is None:
                momentum = {k: t.detach().float().cpu().clone() for k, t in zip(ts.params, ts.opt_state["trace"])}
    finally:
        del trainer.augment
    state.ts = ts
    decay = ref_train.decayed(state.plan.config)
    return {"losses": losses, "first": {k: momentum[k] - weight_decay * before[k] * decay[k] for k in momentum},
            "change": {k: v - before[k] for k, v in cpu(ts.params).items()},
            "augmented": [a for a, _ in kept], "generators": [g for _, g in kept],
            "inputs": [state.batches[j % len(state.batches)] for j in range(n)]}


def put_control(state) -> None:
    """The control in the program's place: the check takes the reference's
    steps with float8 convolutions for the program's."""
    state.control = True


def window(state, seconds: float, spans=None, sample: bool = True, profiling: bool = False) -> dict:
    trainer, batches, mark = state.program, state.batches, marker(profiling)
    cuda = state.device.type == "cuda"
    losses, pending, steps = [], None, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or steps == 0:
        with mark("ronbench.step"):
            state.ts, metrics = trainer.step(state.ts, batches[state.next % len(batches)])
            losses.append(metrics["loss/total"])
            done = torch.cuda.Event() if cuda else None
            if done is not None:
                done.record()
        state.next += 1
        steps += 1
        if pending is not None:
            with mark("ronbench.wait"):
                pending.synchronize()
        pending = done
    with mark("ronbench.wait"):
        if pending is not None:
            pending.synchronize()  # the last step whole, its backward and update too
    t1 = time.perf_counter()
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    b = batches[0]["image01"].shape[0]
    return {"images": steps * b, "steps": steps, "calls": steps, "window_s": t1 - t0, "attempted": steps,
            "failed": failed}


def augment_faults(cfg: dict, inputs, augmented) -> float:
    """Share of the augmentation's promises that a step's batch breaks,
    image by image: the labels passed through, the valid gts a subset of
    the input's, their boxes ordered inside the unit square, and each
    pixel inside its source image's range in each channel (the RON chain
    only moves, scales and mirrors pixels, filling with the image's mean
    colour), at the configuration's input size."""
    means = torch.tensor(scenes.VGG_MEANS)
    broken, total = 0, 0
    for src, aug in zip(inputs, augmented):
        img = src["image01"].cpu().float()
        lo, hi = img.amin(dim=(1, 2)) - means - 1e-3, img.amax(dim=(1, 2)) - means + 1e-3
        out = aug["image"].float()
        shape_ok = tuple(out.shape[:3]) == (img.shape[0], *cfg["img_shape"])
        if not shape_ok:  # rows or pixels missing: every promise of the batch is broken
            n = img.shape[0]
            broken, total = broken + 4 * n, total + 4 * n
            continue
        inside = ((out >= lo[:, None, None]) & (out <= hi[:, None, None])).flatten(1).all(1)
        labels_ok = (aug["gt_labels"].cpu() == src["gt_labels"].cpu()).all(1)
        v, b = aug["gt_valid"].cpu(), aug["gt_boxes"].cpu()
        subset = (~v | src["gt_valid"].cpu()).all(1)
        ordered = (~v[..., None] | ((b >= 0) & (b <= 1))).flatten(1).all(1) & \
            (~v | ((b[..., 0] <= b[..., 2]) & (b[..., 1] <= b[..., 3]))).all(1)
        for ok in (inside, labels_ok, subset, ordered):
            broken, total = broken + int((~ok).sum()), total + int(ok.numel())
    return broken / max(total, 1)


def norm_gap(prog: dict, ref: dict, names) -> float:
    """Largest gap between the program's and the reference's norm of a
    parameter, over the larger of the reference's norm of it and of the
    median parameter's."""
    p = {k: float(prog[k].double().norm()) for k in names}
    r = {k: float(ref[k].double().norm()) for k in names}
    med = statistics.median(r.values())
    return max(abs(p[k] - r[k]) / max(r[k], med) for k in names)


def check(state):
    """-> (checks, counters for the readers). Frees the program first."""
    from ronbench.compare import fp8_ste

    plan, cfg, first, device = state.plan, state.plan.config, state.first, state.device
    state.program = state.ts = state.batches = None
    state.model_dir.cleanup()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    n = len(postprocess.anchors(cfg))
    batches, draws = [], []
    for aug, gen_state in zip(first["augmented"], first["generators"]):
        batches.append({k: v.to(device) for k, v in aug.items()})
        g = torch.Generator(device=device)
        g.set_state(gen_state)
        draws.append(torch.rand((2, aug["gt_labels"].shape[0], n), generator=g, device=device))
    with full_f32():
        losses, grads, change = ref_train.trajectory(cfg, state.weights, batches, draws)
        if state.control:  # the reference in the program's place, one precision step down
            c_losses, c_grads, c_change = ref_train.trajectory(cfg, state.weights, batches, draws, quant=fp8_ste)
            prog = {"losses": c_losses, "first": c_grads, "change": c_change}
        else:
            prog = first
    # parameters whose gradient is nought to rounding in the reference move by round-off alone: left out
    g_norm = {k: float(v.double().norm()) for k, v in grads.items()}
    floor = 1e-3 * statistics.median(g_norm.values())
    names = [k for k in grads if g_norm[k] >= floor]
    checks = [
        {"name": "loss_gap", "value": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], losses)),
         "limit": plan.limit("loss_gap")},
        {"name": "grad_norm_gap", "value": norm_gap(prog["first"], grads, names), "limit": plan.limit("grad_norm_gap")},
        {"name": "change_norm_gap", "value": norm_gap(prog["change"], change, names),
         "limit": plan.limit("change_norm_gap")},
        {"name": "augment_faults", "value": augment_faults(cfg, first["inputs"], first["augmented"]),
         "limit": plan.limit("augment_faults")},
    ]
    found = {"flops_per_image": nets.flops_per_image(cfg), "steps_compared": len(losses),
             "parameters_compared": len(names), "parameters_left_out": len(grads) - len(names)}
    return checks, found
