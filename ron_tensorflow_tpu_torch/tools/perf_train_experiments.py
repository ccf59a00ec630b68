"""A/B of train-step variants on the card: images/s of the whole step
(augmentation, encode, forward, backward, update) under each. The port of
the JAX package's `tools/perf_train_experiments.py`.

    python -m ron_tensorflow_tpu_torch.tools.perf_train_experiments [bs] [variant ...]

Variants (all by default):
  base        the production step: augmentation as `Trainer.augment`, then
              `train/state.py::make_train_step`
  bn_fast     train-time BatchNorm normalized in bf16 with f32 statistics
              (`models/layers.py::set_bn_fast_normalize`)
  remat       `torch.utils.checkpoint` (non-reentrant) over forward + loss:
              nothing saved, the forward recomputed in the backward
  remat_dots  the same with selective checkpointing that saves the
              convolution and matmul outputs
              (`create_selective_checkpoint_contexts`), the counterpart of
              JAX's `dots_saveable` policy
  block1      block 1 through K-B (`fuse_block1`): its forward the kernel,
              its backward the recompute of the unfused block
  block1_bn   block1 + bn_fast
  remat12     blocks 1-2 recomputed in the backward
              (`VGG16Backbone.remat_blocks12`)

The JAX tool's variants that set process-wide `XLA_FLAGS` have no
counterpart. One model serves every variant: its block-1 flags are set
for the variant (the forward reads them at each call) and its parameters,
BatchNorm statistics and optimizer state are put back to the seed-0
initialization before each. In the two remat variants the loss's uniform
draws are taken from the generator before the checkpointed region (the
forward draws nothing, so they are the production step's draws), and the
BatchNorm running statistics that the recompute would update a second
time are put back to the forward's. A variant that fails raises.
bf16, JAX `bench.py`'s synthetic batch (`perf_common.train_parts`); the
generator is seeded 0 at each step.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..losses.ron import draw_uniforms
from ..models import layers
from ..models.vgg import check_block1_forms
from ..train.optimizer import global_norm
from ..train.state import detection_loss_fn, make_train_step, pinned_precision
from .perf_common import ITERS, WARMUP, TrainParts, card_line, parser, timeit, train_parts

BATCH = 32
VARIANTS = ("base", "bn_fast", "remat", "remat_dots", "block1", "block1_bn", "remat12")
BN_FAST = ("bn_fast", "block1_bn")
# the ops whose outputs remat_dots keeps: convolutions (F.conv2d and the
# transposed conv reach aten.convolution) and matmuls
SAVED_OPS = frozenset({torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
                       torch.ops.aten.addmm.default, torch.ops.aten.bmm.default})


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def make_remat_step(model, encoder, tx, loss_config, context_fn=None):
    """`make_train_step` (one process, no EMA) with `torch.utils.checkpoint`
    around forward + loss; `context_fn` selects what it saves."""
    loss = detection_loss_fn(loss_config)
    buffers = list(model.buffers())
    kwargs = {} if context_fn is None else {"context_fn": context_fn}

    def forward_loss(image, targets, draws):
        return loss(model(image, train=True), targets, draws=draws)

    def train_step(state, batch, generator: Optional[torch.Generator] = None):
        targets = encoder.batched(batch["gt_labels"], batch["gt_boxes"], batch["gt_valid"])
        draws = draw_uniforms(targets.labels.shape, generator, targets.labels.device)
        params = list(state.params.values())
        for p in params:
            p.grad = None
        with pinned_precision(model):
            total, metrics = checkpoint(forward_loss, batch["image"], targets, draws, use_reentrant=False, **kwargs)
            forward_stats = [b.clone() for b in buffers]
            total.backward()
        with torch.no_grad():
            for b, s in zip(buffers, forward_stats):
                b.copy_(s)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        tx.step(params, grads, state.opt_state, norm=metrics["grad_norm"])
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    return train_step


def check_variants(variants) -> None:
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variant {unknown[0]!r}; options: {VARIANTS}")


def block1_flags(variant: str) -> Dict[str, bool]:
    return {"fuse_block1": variant.startswith("block1"), "remat_blocks12": variant == "remat12"}


def setup(parts: TrainParts, variant: str, init: Dict[str, torch.Tensor]):
    """Put the model and its optimizer state back to `init` (a
    `state_dict()` copy), set the variant's block-1 flags and return its
    train step."""
    check_variants([variant])
    model = parts.model
    model.load_state_dict(init)
    parts.state.opt_state = parts.tx.init(list(parts.state.params.values()))
    parts.state.step = 0
    flags = block1_flags(variant)
    check_block1_forms(**flags)
    for k, v in flags.items():
        setattr(model.backbone, k, v)
    if variant == "remat":
        return make_remat_step(model, parts.encoder, parts.tx, parts.loss_config)
    if variant == "remat_dots":
        return make_remat_step(model, parts.encoder, parts.tx, parts.loss_config,
                               functools.partial(create_selective_checkpoint_contexts, _dots_saveable))
    return make_train_step(model, parts.encoder, parts.tx, parts.loss_config)


def one_step(parts: TrainParts, step) -> Dict[str, torch.Tensor]:
    """Augmentation and one train step, the generator seeded 0 -> metrics."""
    gen = parts.generator()
    return step(parts.state, parts.augment(gen), gen)[1]


def run(device="cuda", model="ron_320_vgg", bs=BATCH, variants=VARIANTS, iters=ITERS, warmup=WARMUP) -> Dict:
    """-> {variant: {"ms", "img_s"}, "vs_base": {variant: base ms / its ms}}."""
    check_variants(variants)
    parts = train_parts(device, model, bs)
    print(card_line(parts.device))
    init = {k: v.detach().clone() for k, v in parts.model.state_dict().items()}
    res = {}
    for name in variants:
        step = setup(parts, name, init)
        layers.set_bn_fast_normalize(name in BN_FAST)
        try:
            t = timeit(lambda: one_step(parts, step), iters=iters, warmup=warmup, device=parts.device)
        finally:
            layers.set_bn_fast_normalize(False)
        res[name] = {"ms": t * 1e3, "img_s": bs / t}
        print(f"  {name:12s} {t * 1e3:7.2f} ms  -> {bs / t:6.1f} img/s", flush=True)
    setup(parts, "base", init)
    if "base" in res:
        base = res["base"]["ms"]
        res["vs_base"] = {name: base / r["ms"] for name, r in res.items() if name != "base"}
        for name, ratio in res["vs_base"].items():
            print(f"  {name} vs base: {ratio:.3f}x")
    return res


def main(argv=None) -> Dict:
    ap = parser(__doc__)
    ap.add_argument("bs", type=int, nargs="?", default=BATCH, help=f"batch size (default {BATCH})")
    ap.add_argument("variants", nargs="*", default=list(VARIANTS), help="variants (default: all)")
    args = ap.parse_args(argv)
    return run(args.device, args.model, args.bs, tuple(args.variants), args.iters, args.warmup)


if __name__ == "__main__":
    main()
