"""Cumulative decomposition of the RON-320 train step on the card. The port
of the JAX package's `tools/perf_step_probe.py`.

    python -m ron_tensorflow_tpu_torch.tools.perf_step_probe [batch]

`perf_train_breakdown.py` times its stages as functions of their own. This
probe times cumulative variants instead, each adding one stage, and prints
the successive deltas: the cost of each stage in place, the optimizer
update included.

"In place" in eager PyTorch: JAX's variants are separate XLA programs whose
fusion and scheduling the deltas take in. Eager PyTorch fuses nothing, so
here each variant is the production path of `train/state.py::
make_train_step`, as `Trainer.step` runs it (augmentation, then the step,
one generator for both), cut short after its stage:

- aug+encode: `train_augment_batch`, then `TargetEncoder.batched`;
- +fwd+loss: the forward in train mode (BatchNorm statistics updated) and
  the loss, with autograd recording, as the step runs them;
- +bwd: `backward()`, the gradients left in `.grad`;
- +optimizer: the global gradient norm and the optimizer's update of the
  parameters (in place);
- full step: augmentation and `make_train_step` itself (its metrics too).

Nothing needs consuming: eager PyTorch drops no work it was asked for (the
JAX tool sums every output leaf so that XLA cannot). bf16, flax's
initializers from seed 0, JAX `bench.py`'s synthetic batch
(`perf_common.train_parts`); the generator is seeded 0 at each call.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..train.optimizer import global_norm
from ..train.state import detection_loss_fn, make_train_step, pinned_precision
from .perf_common import ITERS, WARMUP, card_line, parser, timeit, train_parts

BATCH = 32
NAMES = ("aug+encode", "+fwd+loss", "+bwd", "+optimizer", "full step")


def run(device="cuda", model="ron_320_vgg", bs=BATCH, iters=ITERS, warmup=WARMUP) -> Dict:
    """-> {variant: {"ms", "delta_ms"}, "img_s": full step img/s}."""
    parts = train_parts(device, model, bs)
    device = parts.device
    print(card_line(device))
    net, encoder, state, tx = parts.model, parts.encoder, parts.state, parts.tx
    loss_fn = detection_loss_fn(parts.loss_config)
    params = list(state.params.values())
    step = make_train_step(net, encoder, tx, parts.loss_config)

    def upto(stage: int):
        """The production path cut after stage `stage` (0: aug+encode .. 3: +optimizer)."""
        def fn():
            gen = parts.generator()
            batch = parts.augment(gen)
            targets = encoder.batched(batch["gt_labels"], batch["gt_boxes"], batch["gt_valid"])
            if stage == 0:
                return targets
            for p in params:
                p.grad = None
            with pinned_precision(net):
                total, metrics = loss_fn(net(batch["image"], train=True), targets, gen)
                if stage == 1:
                    return total
                total.backward()
            if stage == 2:
                return total
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            tx.step(params, grads, state.opt_state, norm=global_norm(grads))
            for p in params:
                p.grad = None
            return total
        return fn

    def full():
        gen = parts.generator()
        return step(state, parts.augment(gen), gen)

    print(f"batch {bs} (cumulative: the production step cut short after each stage)")
    res, prev = {}, 0.0
    for name, fn in zip(NAMES, [upto(0), upto(1), upto(2), upto(3), full]):
        t = timeit(fn, iters=iters, warmup=warmup, device=device)
        res[name] = {"ms": t * 1e3, "delta_ms": (t - prev) * 1e3}
        print(f"  {name:12s} {t * 1e3:7.2f} ms   (delta {1e3 * (t - prev):+7.2f} ms)", flush=True)
        prev = t
    res["img_s"] = bs / prev
    print(f"  -> {bs / prev:.1f} img/s (full step)")
    return res


def main(argv=None) -> Dict:
    ap = parser(__doc__)
    ap.add_argument("batch", type=int, nargs="?", default=BATCH, help=f"batch size (default {BATCH})")
    args = ap.parse_args(argv)
    return run(args.device, args.model, args.batch, args.iters, args.warmup)


if __name__ == "__main__":
    main()
