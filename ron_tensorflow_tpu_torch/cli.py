"""`ron` CLI of the port: the parser of `ron_tensorflow_tpu/cli.py`, with its
two checkpoint subcommands.

  python -m ron_tensorflow_tpu_torch.cli import-ckpt --format torch --source vgg16.pth --model-dir ./model
  python -m ron_tensorflow_tpu_torch.cli import-ckpt --format tf --source ron_320.ckpt --model-dir ./model
  python -m ron_tensorflow_tpu_torch.cli inspect-ckpt --model-dir ./model [--pattern conv1]

`import-ckpt` turns a reference checkpoint (TF slim bundle, torch state
dict, Caffe model) into a step-0 train state in `--model-dir`, from which
`train.trainer.Trainer` resumes (ref: tf_utils.py:186-244). A TF bundle
that holds the whole RON graph (a `reverse_module` scope, under
`--model-scope` or at the top) goes through `slim_ron_to_flat`, its
BatchNorm statistics into the buffers; any other bundle is read as a VGG-16
under `--model-scope` (default 'vgg_16'). Tensors the source lacks keep the
seeded init. Both subcommands run on the CPU.

`inspect-ckpt` lists a model dir's parameters as the JAX package's
`inspect_params` does, by flax name in flax layout
(ref: inspect_checkpoint.py:32-131).

The other subcommands (train, eval, realtime-eval, infer, convert-data,
bench) are in the parser and raise NotImplementedError: they wait for the
config loading, presets and the TFRecord input (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import argparse
import sys

NOT_PORTED = "not ported yet: the CLI's {} subcommand waits for ROADMAP Queue 1 item 5"


def _not_ported(args):
    raise NotImplementedError(NOT_PORTED.format(args.command))


def is_ron_graph(names, scope: str) -> bool:
    """Whether TF tensor names hold the whole RON graph: a `reverse_module`
    scope at the top or under `scope`."""
    return any(n.startswith("reverse_module/") or n.startswith(f"{scope}/reverse_module/") for n in names)


def cmd_import_ckpt(args):
    """Reference checkpoint -> step-0 train state in --model-dir."""
    import numpy as np
    import torch

    from .models import get_network
    from .train.checkpoint import CheckpointManager, load_torch_checkpoint, overlay_params, torch_vgg_to_flat
    from .train.optimizer import OptimizerConfig, make_optimizer
    from .train.state import create_train_state
    from .weights import from_jax_params, to_jax_params

    model, _ = get_network(args.model)
    tx = make_optimizer(OptimizerConfig(learning_rate_decay_type="fixed"), model)
    state = create_train_state(model, tx, torch.Generator().manual_seed(0))
    flat = to_jax_params(model, state.params.items())
    # RON trees scope the VGG under 'backbone/'; SSD keeps its convs at top level
    backbone_prefix = "backbone" if any(k.startswith("backbone/") for k in flat) else ""

    stats_flat = {}
    if args.format == "tf":
        from .train.tf_checkpoint import TFCheckpointReader, slim_ron_to_flat, slim_vgg_to_flat

        tensors = TFCheckpointReader(args.source).load_all()
        ron_scope = args.model_scope or "ron_320_vgg"
        if is_ron_graph(tensors, ron_scope):
            source, stats_flat = slim_ron_to_flat(tensors, source_scope=ron_scope)
        else:
            source = slim_vgg_to_flat(tensors, source_scope=args.model_scope or "vgg_16",
                                      backbone_prefix=backbone_prefix)
    elif args.format == "torch":
        source = torch_vgg_to_flat(load_torch_checkpoint(args.source), backbone_prefix=backbone_prefix,
                                   bgr_to_rgb=args.bgr_to_rgb)
    elif args.format == "caffe":
        from .train.caffe_import import caffe_vgg_to_flat, parse_caffemodel

        source = caffe_vgg_to_flat(parse_caffemodel(args.source), backbone_prefix=backbone_prefix,
                                   bgr_to_rgb=args.bgr_to_rgb)
    else:
        raise ValueError(f"unknown format {args.format!r}")

    out, restored = overlay_params(flat, source)
    with torch.no_grad():
        for name, value in from_jax_params({k: out[k] for k in restored},
                                           {k: np.asarray(v) for k, v in stats_flat.items()}).items():
            (state.params if name in state.params else state.batch_stats)[name].copy_(value)
    CheckpointManager(args.model_dir).save(0, state)
    print(f"imported {args.format} checkpoint -> {args.model_dir} (step 0)")


def cmd_inspect_ckpt(args):
    """Parameters of --model-dir's newest step, by flax name and layout."""
    from .models import get_network
    from .train.checkpoint import CheckpointManager, inspect_params
    from .weights import to_jax_params

    model, _ = get_network(args.model)
    variables, step = CheckpointManager(args.model_dir).restore_eval()
    print(f"step: {step}")
    for line in inspect_params(to_jax_params(model, variables["params"].items()), args.pattern):
        print(line)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ron", description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    for name, help_ in (("train", "train a detector"), ("eval", "streaming mAP eval on TFRecords"),
                        ("realtime-eval", "official VOCdevkit eval"), ("infer", "detect objects in images"),
                        ("convert-data", "VOC -> TFRecord shards"), ("bench", "run the repo benchmark")):
        sub.add_parser(name, help=f"{help_} (not ported yet)").set_defaults(fn=_not_ported)

    m = sub.add_parser("import-ckpt", help="convert a TF/torch/caffe checkpoint to a model dir")
    m.add_argument("--format", required=True, choices=("tf", "torch", "caffe"))
    m.add_argument("--source", required=True, help="checkpoint path/prefix")
    m.add_argument("--model", default="ron_320_vgg")
    m.add_argument("--model-dir", required=True)
    m.add_argument("--model-scope", default=None, help="source graph scope name")
    m.add_argument("--bgr-to-rgb", action="store_true")
    m.set_defaults(fn=cmd_import_ckpt)

    k = sub.add_parser("inspect-ckpt", help="list checkpoint tensors")
    k.add_argument("--model", default="ron_320_vgg")
    k.add_argument("--model-dir", required=True)
    k.add_argument("--pattern", default=None)
    k.set_defaults(fn=cmd_inspect_ckpt)

    return p


def main(argv=None):
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if extra and args.fn is not _not_ported:  # the JAX CLI's arguments of a subcommand not ported yet pass
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
