"""Stage-wise timing of the RON-320 train step on the card, each stage a
function of its own. The port of the JAX package's
`tools/perf_train_breakdown.py`.

    python -m ron_tensorflow_tpu_torch.tools.perf_train_breakdown [batch]

bf16 RON-320 from flax's initializers (seed 0), the momentum optimizer at
a fixed learning rate, JAX `bench.py`'s synthetic batch (uint8 noise on the
512 canvas, one box) on the card (`perf_common.train_parts`). The stages,
each timed alone by `perf_common.timeit`, over the port's
`train/state.py` pieces:

- augment: `data/preprocess.py::train_augment_batch` of the raw batch;
- augment+encode: and `TargetEncoder.batched` of its gts;
- fwd+loss: the forward with inference BatchNorm and the loss
  (`detection_loss_fn`), no autograd, as the JAX tool's `train=False`;
- grad (fwd+bwd): the forward in train mode, the loss and the gradient
  with respect to the parameters;
- full train step: `make_train_step` (encode, forward, loss, backward,
  global norm, update) on the augmented image with the raw gts, as the
  JAX tool feeds it. The state is updated in place at each call.

Every stage draws from a generator seeded 0 at each call.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..train.state import detection_loss_fn, make_train_step, pinned_precision
from .perf_common import ITERS, WARMUP, card_line, parser, timeit, train_parts

BATCH = 32


def run(device="cuda", model="ron_320_vgg", bs=BATCH, iters=ITERS, warmup=WARMUP) -> Dict:
    """-> {"augment", "augment+encode", "encode", "fwd+loss", "grad (fwd+bwd)", "full train step": ms,
    "img_s": full step img/s}."""
    parts = train_parts(device, model, bs)
    device = parts.device
    print(card_line(device))
    net, encoder, raw = parts.model, parts.encoder, parts.raw
    loss_fn = detection_loss_fn(parts.loss_config)
    params = list(parts.state.params.values())

    def stage_aug():
        return parts.augment(parts.generator())

    def stage_aug_encode():
        batch = stage_aug()
        return batch["image"], encoder.batched(batch["gt_labels"], batch["gt_boxes"], batch["gt_valid"])

    image, targets = stage_aug_encode()

    def stage_fwd_loss():
        with torch.no_grad(), pinned_precision(net):
            return loss_fn(net(image, train=False), targets, parts.generator())[0]

    def stage_grad():
        with pinned_precision(net):
            total = loss_fn(net(image, train=True), targets, parts.generator())[0]
            return torch.autograd.grad(total, params)

    step = make_train_step(net, encoder, parts.tx, parts.loss_config)
    batch = {"image": image, "gt_labels": raw["gt_labels"], "gt_boxes": raw["gt_boxes"], "gt_valid": raw["gt_valid"]}

    def full():
        return step(parts.state, batch, parts.generator())

    t = {name: timeit(fn, iters=iters, warmup=warmup, device=device) for name, fn in (
        ("augment", stage_aug), ("augment+encode", stage_aug_encode), ("fwd+loss", stage_fwd_loss),
        ("grad (fwd+bwd)", stage_grad), ("full train step", full))}
    ms = lambda s: f"{s * 1e3:7.2f} ms"  # noqa: E731
    print(f"batch {bs}")
    print(f"  augment          {ms(t['augment'])}")
    print(f"  augment+encode   {ms(t['augment+encode'])}   (encode ~ {ms(t['augment+encode'] - t['augment'])})")
    print(f"  fwd+loss         {ms(t['fwd+loss'])}")
    print(f"  grad (fwd+bwd)   {ms(t['grad (fwd+bwd)'])}")
    print(f"  full train step  {ms(t['full train step'])}  ->  {bs / t['full train step']:.1f} img/s", flush=True)
    res = {k: v * 1e3 for k, v in t.items()}
    res["encode"] = res["augment+encode"] - res["augment"]
    res["img_s"] = bs / t["full train step"]
    return res


def main(argv=None) -> Dict:
    ap = parser(__doc__)
    ap.add_argument("batch", type=int, nargs="?", default=BATCH, help=f"batch size (default {BATCH})")
    args = ap.parse_args(argv)
    return run(args.device, args.model, args.batch, args.iters, args.warmup)


if __name__ == "__main__":
    main()
