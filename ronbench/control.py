"""The readings that the limits of `correct` are set from, on the card.

    python -m ronbench.control --workload <cell> --seconds 2 --seeds 1 2 3 ... --control-seeds 4 5 6

For each of `--seeds`, the cell's own set-up and a short window at the
cell's load, then its check: the program's readings. For each of
`--control-seeds`, the same with the control in the program's place: the
reference, one precision step below what the configuration states (its
bfloat16 forward as float8 e4m3 convolutions, its float32 postprocess in
bfloat16). With `--fault`, the program's readings with that fault planted
in the program (`FAULTS`). One JSON line a seed; a sound limit lies above
every program reading and below every control reading. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

from ronbench import compare, harness
from ronbench.program import Recorder, full_f32, heads_of
from ronbench.reference import nets, postprocess

HEADS = {"detect": ("scores", "boxes"), "realtime": ("scores", "labels", "boxes", "valid")}


class ControlModel:
    """The reference's forward with every convolution's input and kernel
    rounded to float8."""

    def __init__(self, cfg: dict, weights: dict, device):
        self.cfg, self.weights, self.device = cfg, weights, device

    def __call__(self, images):
        with full_f32():
            return nets.heads(self.cfg, self.weights, torch.as_tensor(images, device=self.device).float(),
                              quant=compare.fp8)


class ControlHead:
    """A detection head of the reference, its postprocess in bfloat16,
    answering as the port's head of the entry does."""

    def __init__(self, cfg: dict, weights: dict, device, entry: str):
        self.cfg, self.entry = cfg, entry
        self.model = ControlModel(cfg, weights, device)

    def __call__(self, images):
        out = postprocess.HEADS[self.entry](heads_of(self.model(images)), self.cfg, torch.bfloat16)
        return tuple(out[k].float() if out[k].is_floating_point() else out[k] for k in HEADS[self.entry])


def put_control(state) -> None:
    """The control in the program's place of a set-up state (an entry that
    has its own way, `put_control`, takes it)."""
    own = getattr(state.plan.entry, "put_control", None)
    if own is not None:
        own(state)
        return
    entry = state.plan.traffic["entry"]
    state.program = ControlHead(state.plan.config, state.weights, state.device, entry)
    state.program.model = Recorder(state.program.model)


def unchanged(step):
    """A train step that returns its state as it was."""
    def faulty(self, state, batch):
        self.augment(batch, self.generator(state.step))
        return state, {"loss/total": torch.zeros((), device=batch["image01"].device)}

    return faulty


def half_batch(step):
    """A train step that augments the whole batch and then trains on its
    first half only, its loss the mean over those rows."""
    def faulty(self, state, batch):
        generator = self.generator(state.step)
        rows = self.augment(batch, generator)
        return self._train_step(state, {k: v[: v.shape[0] // 2] for k, v in rows.items()}, generator)

    return faulty


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}


@contextlib.contextmanager
def planted(fault: str):
    """`Trainer.step` of the port replaced by the fault's, restored on exit."""
    from ron_tensorflow_tpu_torch.train.trainer import Trainer

    step = Trainer.step
    Trainer.step = FAULTS[fault](step)
    try:
        yield
    finally:
        Trainer.step = step


def readings(plan, seed: int, seconds: float, device, control: bool, fault: str = "") -> dict:
    with planted(fault) if fault else contextlib.nullcontext():
        state = plan.entry.setup(plan, seed, device)
    if control:
        put_control(state)
    counters = plan.entry.window(state, seconds)
    checks, found = plan.entry.check(state)
    return {"seed": seed, "control": control, "fault": fault, "calls": counters["calls"],
            "checks": {c["name"]: c["value"] for c in checks},
            "found": {k: v for k, v in found.items() if isinstance(v, (int, float))}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(FAULTS), default="", help="plant a fault in the program's seeds' runs")
    args = ap.parse_args(argv)
    root = Path.cwd()
    harness.cache_dirs(root)
    if not torch.cuda.is_available():
        print("ronbench.control: no CUDA device", file=sys.stderr)
        return 2
    plan = harness.resolve(root, args.workload)
    print(harness.card_line(), flush=True)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            print(json.dumps(readings(plan, seed, args.seconds, torch.device("cuda"), control,
                                      "" if control else args.fault)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
