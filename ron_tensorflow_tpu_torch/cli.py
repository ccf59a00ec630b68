"""`ron` CLI of the port: train / eval / realtime-eval / infer /
convert-data / import-ckpt / inspect-ckpt / bench, the subcommands and
arguments of `ron_tensorflow_tpu/cli.py`.

  python -m ron_tensorflow_tpu_torch.cli convert-data --voc-root ./VOCdevkit/VOC2007 --output-dir ./records
  python -m ron_tensorflow_tpu_torch.cli train --config cfg.json --dataset-dir ./records data.batch_size=32
  python -m ron_tensorflow_tpu_torch.cli eval --model-dir ./model --dataset-dir ./records
  python -m ron_tensorflow_tpu_torch.cli realtime-eval --model-dir ./model --voc-root ./VOCdevkit
  python -m ron_tensorflow_tpu_torch.cli infer --model-dir ./model --output-dir ./Debug a.jpg b.jpg
  python -m ron_tensorflow_tpu_torch.cli import-ckpt --format torch --source vgg16.pth --model-dir ./model
  python -m ron_tensorflow_tpu_torch.cli inspect-ckpt --model-dir ./model [--pattern conv1]
  python -m ron_tensorflow_tpu_torch.cli bench

`--device` (before the subcommand) replaces the JAX CLI's `--platform`:
"cuda" by default, "cpu" only when asked for; without a card the default
raises. `train` and `eval` take `--preset`, `--config` (a JSON file of the
JAX package's format) and dotted `key=value` overrides; an unknown key
raises KeyError. `eval` scores the newest checkpoint of `--model-dir` over
the TFRecord shards (every image: the last batch is padded and its padding
rows masked), or with `wait_for_checkpoints=true` every new checkpoint until
`max_evals`. A bf16 `eval` on the card runs block 1 through the fused
kernel (K-B), as the JAX CLI does on an accelerator; `realtime-eval` and
`infer` (one image at a time, as in the reference) and every CPU run keep
it unfused.

`infer` runs the realtime head (`RealtimeDetector`, K-C on the card) on
each image, f32 at batch 1: a JPEG (baseline or progressive) or a PNG,
decoded by the port's own decoders with PIL's bits, as the JAX CLI opens
the file with PIL (`data/decode.py`, route "pil"; another format, or a
JPEG frame the decoder refuses, raises ValueError naming the file),
TF1-resized to the network's input, whitened on the device; it draws the
detections on the resized image in numpy and writes them with the port's
JPEG encoder at Pillow's defaults (`utils/visualization.py`: no PIL) into
`--output-dir/<i>.jpg`, and prints `<path>: <n> detections -> <picture>`,
as the JAX CLI does.

Several processes: under `python -m torch.distributed.run --nproc-per-node N
-m ron_tensorflow_tpu_torch.cli train|eval ... mesh_shape=[N,1]`, `train`
and `eval` initialize torch.distributed from its `env://` variables (NCCL
on the card, gloo on the CPU, or `--dist-backend`), each rank on
`cuda:LOCAL_RANK` (or the `--device` given with an index), and run on the
config's `mesh_shape` ((world, 1) by default). Only rank 0 prints results.
Two ranks on one card need `--device cuda:0 --dist-backend gloo` (NCCL
takes one rank per device).

`import-ckpt` turns a reference checkpoint (TF slim bundle, torch state
dict, Caffe model) into a step-0 train state in `--model-dir`, from which
the Trainer resumes (ref: tf_utils.py:186-244). A TF bundle that holds the
whole RON graph (a `reverse_module` scope, under `--model-scope` or at the
top) goes through `slim_ron_to_flat`, its BatchNorm statistics into the
buffers; any other bundle is read as a VGG-16 under `--model-scope`
(default 'vgg_16'). Tensors the source lacks keep the seeded init. It and
`inspect-ckpt` (parameters by flax name in flax layout, ref:
inspect_checkpoint.py:32-131) run on the CPU.

`--debug-nans` (before the subcommand, as in the JAX CLI, where it sets
`jax_debug_nans`) turns on `torch.autograd.set_detect_anomaly` for the
command and hooks every module of the model that `train`, `eval`,
`realtime-eval` or `infer` runs: the first NaN in a module's output raises
`FloatingPointError` naming the module (`utils/debug_nans.py`). Without the
flag neither is on.

`--spans` (before the subcommand) enables the port's tracer
(`utils/profiling.py`) for `train`, `eval`, `realtime-eval` and `infer`,
and at exit prints its table on standard error: each span's calls and
mean and largest host and device ms, each counter's total and its mean a
call. `train` also logs each span's means at every log step.

`bench` runs `bench.main` on `--device`: the JAX `bench.py`'s workload
(the Detector at batch 32, train steps at batch 14 and 32, the realtime
head's batch-1 latency) at RON-320, printed as one JSON line with the keys
of that script's record.
"""

from __future__ import annotations

import argparse
import sys
import time

def _preset(kind: str, name):
    if not name:
        return None
    from .presets import get_preset

    return get_preset(kind, name)


def is_ron_graph(names, scope: str) -> bool:
    """Whether TF tensor names hold the whole RON graph: a `reverse_module`
    scope at the top or under `scope`."""
    return any(n.startswith("reverse_module/") or n.startswith(f"{scope}/reverse_module/") for n in names)


def fuse_block1_for_eval(spec, device, bfloat16: bool) -> bool:
    """Whether batched inference runs block 1 through K-B (JAX
    `cli.py:67-87`): bf16 on a CUDA device, at a shape the kernel takes.
    The batch-1 realtime path keeps the unfused layers, as JAX's does."""
    from .kernels import fused_block1_supported

    return bfloat16 and device.type == "cuda" and fused_block1_supported(*spec.img_shape)


def restore_for_eval(model, model_dir: str, use_ema: bool = False, step=None) -> int:
    """Inference-only restore (JAX `cli.py:44-64`): the checkpoint's (the
    newest by default) parameters (or EMA) and BatchNorm statistics into
    `model`, in place, whatever optimizer trained it; returns the step."""
    from .train.checkpoint import CheckpointManager

    variables, step = CheckpointManager(model_dir).restore_eval(step, use_ema=use_ema)
    model.load_state_dict({**variables["params"], **variables["batch_stats"]}, strict=True)
    return step


def watch_nans(args, model) -> None:
    """Under `--debug-nans`: a NaN check on every module's output of `model`."""
    if args.debug_nans:
        from .utils.debug_nans import nan_hooks

        nan_hooks(model)


def distributed_device(args):
    """This process's device, after torch.distributed is initialized from
    a launcher's `env://` variables (nothing when there are none)."""
    from .parallel import initialize_distributed, local_device

    device = local_device(args.device)
    initialize_distributed(backend=args.dist_backend, device=device)
    return device


def cmd_train(args):
    from .config import TrainConfig, load_config
    from .train.trainer import Trainer

    overrides = list(args.overrides)
    if args.model_dir:
        overrides.append(f"model_dir={args.model_dir}")
    if args.dataset_dir:
        overrides.append(f"data.dataset_dir={args.dataset_dir}")
    cfg = load_config(TrainConfig, args.config, overrides, base=_preset("train", args.preset))
    trainer = Trainer(cfg, device=distributed_device(args))
    watch_nans(args, trainer.model)
    trainer.train()


def cmd_eval(args):
    import torch

    from . import resolve_device
    from .config import EvalConfig, load_config
    from .data.pipeline import PipelineConfig, PrefetchIterator, batch_iterator
    from .data.tfrecord import list_shards
    from .eval import StreamingEvaluator
    from .inference.detector import DetectionConfig
    from .losses.ron import RonLossConfig
    from .losses.ssd import SsdLossConfig
    from .models import get_network, get_spec
    from .parallel.collectives import broadcast_int
    from .parallel.mesh import make_mesh, world_size
    from .train.checkpoint import CheckpointManager

    cfg = load_config(EvalConfig, args.config, args.overrides, base=_preset("eval", args.preset))
    model_dir = args.model_dir or cfg.model_dir
    dataset_dir = args.dataset_dir or cfg.data.dataset_dir
    device = resolve_device(distributed_device(args))
    mesh = make_mesh(cfg.mesh_shape) if cfg.mesh_shape or world_size() > 1 else None
    primary = mesh is None or mesh.rank == 0
    fuse = fuse_block1_for_eval(get_spec(cfg.model), device, cfg.bfloat16)
    model, spec = get_network(cfg.model, dtype=torch.bfloat16 if cfg.bfloat16 else torch.float32, fuse_block1=fuse)
    watch_nans(args, model)

    files = list_shards(dataset_dir, cfg.data.file_pattern)
    if not files:
        raise FileNotFoundError(f"no shards matching {cfg.data.file_pattern!r} in {dataset_dir!r}")
    pcfg = PipelineConfig(
        batch_size=cfg.data.batch_size,
        working_shape=spec.img_shape,
        max_boxes=cfg.data.max_boxes,
        shuffle=False,
        keep_difficult=True,
        eval_resize=cfg.resize,  # TF1 legacy bilinear + box remap
        output_dtype="uint8",  # a quarter of the upload; the evaluator whitens on the device
    )

    def eval_batches():
        # drop_remainder=False: every image is scored (the last batch is
        # padded and its padding rows masked by sample_valid)
        for hb in PrefetchIterator(batch_iterator(files, pcfg, epochs=1, drop_remainder=False)):
            yield {"image": hb["image01"], "gt_labels": hb["gt_labels"], "gt_boxes": hb["gt_boxes"],
                   "gt_difficult": hb["gt_difficult"], "sample_valid": hb["sample_valid"]}

    loss_config = None
    if cfg.report_loss:
        loss_config = (SsdLossConfig(num_classes=spec.num_classes, match_threshold=cfg.match.positive_threshold)
                       if cfg.model.startswith("ssd") else RonLossConfig(num_classes=spec.num_classes))
    ev = StreamingEvaluator(
        model,
        spec,
        DetectionConfig(select_threshold=cfg.select_threshold, objectness_threshold=cfg.objectness_threshold,
                        top_k=cfg.select_top_k, keep_top_k=cfg.keep_top_k, nms_threshold=cfg.nms_threshold,
                        shared_top_k=cfg.shared_top_k),
        cfg.matching_threshold,
        device=device,
        loss_config=loss_config,
        loss_match_threshold=cfg.match.positive_threshold,
        loss_ignore_threshold=cfg.match.ignore_threshold,
        mesh=mesh,
    )

    # one-shot by default; with wait_for_checkpoints, every new checkpoint
    # of model_dir (the reference's slim evaluation_loop, ref: eval_ssd_network.py:305-340)
    mgr = CheckpointManager(model_dir)
    if not cfg.wait_for_checkpoints and mgr.latest_step() is None:
        raise FileNotFoundError(f"no checkpoint in {model_dir}")
    evaluated_step, n_done = None, 0
    while True:
        latest = broadcast_int(-1 if mgr.latest_step() is None else mgr.latest_step())  # rank 0's on every rank
        if latest >= 0 and latest != evaluated_step:
            step = restore_for_eval(ev.detector.model, model_dir, cfg.use_ema, latest)
            map07, map12, aps07, stats = ev.run(eval_batches(), cfg.max_batches, debug_dir=cfg.debug_dir,
                                                debug_max_images=cfg.debug_max_images)
            evaluated_step, n_done = step, n_done + 1
            if primary:
                print(f"[eval] restored step {step}")
                for cls, ap in sorted(aps07.items()):
                    print(f"  AP07[class {cls:2d}] = {ap:.4f}")
                print(f"mAP (VOC07 metric) = {map07:.4f}")
                print(f"mAP (VOC12 metric) = {map12:.4f}")
                for k in sorted(stats):
                    if k.startswith("loss/"):
                        print(f"{k} = {stats[k]:.4f}")
                print(f"eval speed: {stats['sec_per_image']:.4f} sec/image")
        if not cfg.wait_for_checkpoints:
            break
        if cfg.max_evals is not None and n_done >= cfg.max_evals:
            break
        time.sleep(cfg.eval_interval_secs)
        mgr.reload()  # pick up checkpoints written by the training job


def cmd_realtime_eval(args):
    from . import resolve_device
    from .eval import RealtimeEvaluator
    from .inference.detector import RealtimeConfig
    from .models import get_network

    device = resolve_device(args.device)
    model, spec = get_network(args.model)  # f32, block 1 unfused: the batch-1 path
    watch_nans(args, model)
    step = restore_for_eval(model, args.model_dir, args.use_ema)
    print(f"[ron-eval] restored step {step}")
    # SSD models get the streaming eval's class-wise settings (the objectness override does not apply)
    rt = RealtimeEvaluator(model, spec, RealtimeConfig.for_spec(spec, objectness_threshold=args.objectness_threshold),
                           device=device)
    mean_ap, aps = rt.evaluate_voc(args.voc_root, args.set_type, max_images=args.max_images,
                                   output_dir=args.output_dir, debug_dir=args.debug_dir)
    for cls, ap in aps.items():
        print(f"AP for {cls} = {ap:.4f}")
    print(f"Mean AP = {mean_ap:.4f}")


def infer_images(det, paths, output_dir):
    """The realtime head `det` (a `RealtimeDetector`) on each image (JPEG
    or PNG) of `paths`, one at a time: decode with PIL's bits, TF1 resize
    to the network's input, /255, whiten on the device, detect, draw into
    `output_dir/<i>.jpg`.
    Returns [(path, scores, labels, boxes, picture)], the valid detections
    as numpy arrays, as drawn."""
    import numpy as np
    import torch

    from .data.decode import decode_image
    from .data.preprocess import whiten
    from .data.resize import tf1_bilinear_resize
    from .utils.visualization import save_image_with_boxes

    results = []
    for i, path in enumerate(paths):
        with open(path, "rb") as f:
            data = f.read()
        try:
            raw = decode_image(data, route="pil")
        except ValueError as e:
            raise ValueError(f"{path}: the port's decoders do not take this file ({e})") from e
        # TF1-legacy bilinear: the numerics the checkpoints expect
        img01 = tf1_bilinear_resize(raw, det.spec.img_shape) / 255.0
        image = whiten(torch.from_numpy(img01).to(det.device))[None]
        scores, labels, boxes, valid = (t[0].cpu().numpy() for t in det(image))
        out = save_image_with_boxes(img01, boxes[valid], labels[valid], scores[valid], directory=output_dir, index=i)
        results.append((path, scores[valid], labels[valid], boxes[valid], out))
    return results


def cmd_infer(args):
    from . import resolve_device
    from .inference.detector import RealtimeConfig, RealtimeDetector
    from .models import get_network

    device = resolve_device(args.device)
    model, spec = get_network(args.model)  # f32, block 1 unfused: the batch-1 path
    watch_nans(args, model)
    restore_for_eval(model, args.model_dir, args.use_ema)
    det = RealtimeDetector(model, spec, RealtimeConfig.for_spec(spec, objectness_threshold=args.objectness_threshold),
                           device=device)
    for path, scores, _, _, out in infer_images(det, args.images, args.output_dir):
        print(f"{path}: {len(scores)} detections -> {out}")


def cmd_convert_data(args):
    from .data.convert import convert_voc

    n = convert_voc(args.voc_root, args.output_dir, args.output_name, shuffle_seed=args.shuffle_seed)
    print(f"converted {n} samples -> {args.output_dir}")


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


def cmd_bench(args):
    from . import bench

    bench.main(device=args.device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ron", description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device of train, eval, realtime-eval, infer and bench "
                   "(default: cuda; cuda:LOCAL_RANK under torch.distributed.run)")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="torch.distributed backend under torch.distributed.run (default: nccl on cuda, gloo on cpu)")
    p.add_argument("--debug-nans", action="store_true",
                   help="anomaly detection, and FloatingPointError at the first NaN a module of the model outputs, "
                        "naming the module (jax_debug_nans in the JAX CLI; ref: ron_net.py:399-402)")
    p.add_argument("--spans", action="store_true",
                   help="time the program's stages (host and device ms a span, bytes uploaded) in train, eval, "
                        "realtime-eval and infer, and print the table on standard error at exit")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train a detector")
    t.add_argument("--preset", default=None, help="named recipe (ron_320/ssd_300/ssd_512)")
    t.add_argument("--config", default=None)
    t.add_argument("--model-dir", default=None)
    t.add_argument("--dataset-dir", default=None)
    t.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="streaming mAP eval on TFRecords")
    e.add_argument("--preset", default=None, help="named recipe (ron_320/ssd_300/ssd_512)")
    e.add_argument("--config", default=None)
    e.add_argument("--model-dir", default=None)
    e.add_argument("--dataset-dir", default=None)
    e.add_argument("overrides", nargs="*")
    e.set_defaults(fn=cmd_eval)

    r = sub.add_parser("realtime-eval", help="official VOCdevkit eval")
    r.add_argument("--model", default="ron_320_vgg")
    r.add_argument("--model-dir", required=True)
    r.add_argument("--voc-root", required=True)
    r.add_argument("--set-type", default="test")
    r.add_argument("--max-images", type=int, default=None)
    r.add_argument("--output-dir", default="./output_test")
    r.add_argument("--objectness-threshold", type=float, default=0.95)
    r.add_argument("--use-ema", action="store_true")
    r.add_argument("--debug-dir", default=None, help="dump boxed JPEGs of the detections (ref: ron_eval.py:553-555)")
    r.set_defaults(fn=cmd_realtime_eval)

    i = sub.add_parser("infer", help="detect objects in images")
    i.add_argument("images", nargs="+")
    i.add_argument("--model", default="ron_320_vgg")
    i.add_argument("--model-dir", required=True)
    i.add_argument("--output-dir", default="./Debug")
    i.add_argument("--objectness-threshold", type=float, default=0.95)
    i.add_argument("--use-ema", action="store_true")
    i.set_defaults(fn=cmd_infer)

    c = sub.add_parser("convert-data", help="VOC -> TFRecord shards")
    c.add_argument("--voc-root", required=True, help="VOCdevkit/VOC2007 style dir")
    c.add_argument("--output-dir", required=True)
    c.add_argument("--output-name", default="voc_2007_train")
    c.add_argument("--shuffle-seed", type=int, default=None)
    c.set_defaults(fn=cmd_convert_data)

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

    sub.add_parser("bench", help="run the repo benchmark").set_defaults(fn=cmd_bench)
    return p


SPAN_COMMANDS = ("train", "eval", "realtime-eval", "infer")


def main(argv=None):
    args = build_parser().parse_args(argv)
    anomaly = None
    if args.debug_nans:
        import torch

        anomaly = torch.is_anomaly_enabled()
        torch.autograd.set_detect_anomaly(True)
    spans = args.spans and args.command in SPAN_COMMANDS
    if spans:
        from .utils import profiling

        profiling.reset()
        profiling.enable()
    try:
        return args.fn(args)
    finally:
        if anomaly is not None:
            torch.autograd.set_detect_anomaly(anomaly)
        if spans:
            profiling.disable()
            print(profiling.format_snapshot(profiling.snapshot()), file=sys.stderr)
        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
