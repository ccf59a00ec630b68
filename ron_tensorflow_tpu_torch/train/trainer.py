"""The trainer: config in, trained checkpoints out.

Port of `ron_tensorflow_tpu/train/trainer.py` for one device. Each step:
host batch (uint8 or float [0, 1] images at the working canvas, padded gts)
-> upload (`DevicePrefetcher`, one batch ahead) -> augmentation on the
device -> `make_train_step` (encode, forward, loss, backward, update, EMA).
Around it, as the JAX trainer does:

- auto-resume from the newest checkpoint in `model_dir`;
- a generator per step seeded from (seed, step), so that a resumed run
  draws what an unbroken one would (the counterpart of
  `fold_in(PRNGKey(seed), step)`, trainer.py:362); the step's augmentation
  draws come first, then the loss's;
- at each log step: the NaN guard (`FloatingPointError`), JSONL metrics
  (`MetricsWriter`) and images/s;
- step- and time-based checkpoints, and the host-RSS guard (save, then
  `SystemExit(75)`);
- debug images of the augmented batch with its gt boxes.

The SSD models train as in the JAX trainer (trainer.py:109-125): the
'ssd' augmentation when `augment_variant` is 'auto', and the hard-negative
loss `SsdLossConfig(num_classes, match_threshold=match.positive_threshold)`
in place of `config.loss`; their dropout draws from the step's generator.

K-B (the fused block-1 kernel, with its recompute backward) is on where the
JAX trainer turns it on (trainer.py:84-100): `fuse_block1` asked for, a
bf16 model, one device, a CUDA device and a shape `fused_block1_supported`
takes (RON-320, SSD-300 and SSD-512 alike).

Warm start (trainer.py:161-229, ref: tf_utils.py:186-244): when `model_dir`
holds no checkpoint, `checkpoint_path` is read by the importer of
`checkpoint_format` ('torch': a torchvision or ssd.pytorch VGG-16; 'tf': a
TF slim bundle under `checkpoint_model_scope or 'vgg_16'`; 'caffe'; 'orbax':
the npz of `tools/orbax_to_npz.py`), overlaid on the seeded parameters in
flax names by `warm_start_params`' rule (`checkpoint_exclude_scopes`, the
rename {'backbone': checkpoint_model_scope}), and the restored tensors are
copied into the model's parameters in place (`weights.from_jax_params`
gives their torch layout). BatchNorm statistics and the EMA keep their
seeded values, as in the JAX trainer, which replaces `params` only after
the EMA was copied from them (ROADMAP Queue 3).

With `tensorboard=True` the scalars of each log step go to an
`events.out.tfevents.*` file in `model_dir` as well (`utils/tensorboard.py`),
and the debug images too where PIL is installed; without PIL the trainer
says once that it writes no images.

Input: `train()` reads the TFRecord shards of `config.data` through
`make_batches` (the ported `batch_iterator`), or takes host batches.

Not ported yet, and raising: a mesh over several devices and the Grain
pipeline (ROADMAP Queue 1 item 4), `s2d_stem`.
"""

from __future__ import annotations

import importlib.util
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import TrainConfig, print_config
from ..data.pipeline import DevicePrefetcher, PipelineConfig, PrefetchIterator, batch_iterator
from ..data.preprocess import PreprocessConfig, train_augment_batch, unwhiten
from ..data.tfrecord import list_shards
from ..kernels import fused_block1_supported
from ..losses.ssd import SsdLossConfig
from ..models import get_network, get_spec
from ..ops.encode import TargetEncoder
from ..utils.profiling import StepTimer
from ..utils.summaries import MetricsWriter
from ..weights import from_jax_params, to_jax_params
from .checkpoint import (
    CheckpointManager,
    load_orbax_npz,
    load_torch_checkpoint,
    overlay_params,
    torch_vgg_to_flat,
)
from .optimizer import make_optimizer
from .state import TrainState, create_train_state, make_eval_step, make_train_step


def _host_rss_gb() -> float:
    """This process's resident set size in GB (Linux)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e9
    except (OSError, ValueError, IndexError):
        return 0.0


def step_seed(seed: int, step: int) -> int:
    """A 63-bit seed for step `step` of a run seeded `seed`."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def has_pil() -> bool:
    return importlib.util.find_spec("PIL") is not None


def _not_ported(config: TrainConfig) -> Optional[str]:
    if config.mesh_shape and config.mesh_shape[0] * config.mesh_shape[1] > 1:
        return "a mesh over several devices (ROADMAP Queue 1 item 4)"
    if config.s2d_stem:
        return "s2d_stem (measured slower on the TPU; to port only after a measurement on the card)"
    if config.data.use_grain:
        return "the Grain input pipeline (ROADMAP Queue 1 item 4)"
    return None


class Trainer:
    """`Trainer(config, device="cuda")`: raises without a card unless the
    caller asks for `device="cpu"`."""

    def __init__(self, config: TrainConfig, device="cuda"):
        missing = _not_ported(config)
        if missing:
            raise NotImplementedError(f"not ported yet: {missing}")
        self.config = config
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if config.bfloat16 else torch.float32
        ssd = config.model.startswith("ssd")
        spec = get_spec(config.model)
        fuse = (config.fuse_block1 and config.bfloat16 and self.device.type == "cuda"
                and fused_block1_supported(*spec.img_shape))
        kwargs = {} if ssd else {"bn_fast_normalize": config.bn_fast_normalize}
        self.model, self.spec = get_network(config.model, dtype=dtype, fuse_block1=fuse, **kwargs)
        self.encoder = TargetEncoder(spec.anchor_layout(), spec.img_shape, config.match.positive_threshold,
                                     config.match.ignore_threshold, spec.prior_scaling)
        self.tx = make_optimizer(config.optimizer, self.model)
        variant = config.augment_variant
        if variant == "auto":
            variant = "ssd" if ssd else "ron"
        self.preprocess_config = PreprocessConfig(out_shape=spec.img_shape, variant=variant)
        # SSD models train with the hard-negative-mining loss family
        self.loss_config = (SsdLossConfig(num_classes=spec.num_classes, match_threshold=config.match.positive_threshold)
                            if ssd else config.loss)
        self._train_step = make_train_step(self.model, self.encoder, self.tx, self.loss_config, config.ema_decay)
        self.eval_step = make_eval_step(self.model, self.encoder, self.loss_config)
        self._ckpt = CheckpointManager(config.model_dir, max_to_keep=config.max_to_keep)
        self.state: Optional[TrainState] = None
        self._said_no_pil = False

    # ------------------------------------------------------------------ #

    def init_state(self) -> TrainState:
        """Parameters initialized as flax does from `config.seed` (drawn on
        the CPU); then the newest checkpoint in `model_dir` if there is one,
        else the warm start from `checkpoint_path` if one is given."""
        self.model.to(self.device)
        state = create_train_state(self.model, self.tx, torch.Generator().manual_seed(self.config.seed),
                                   ema=self.config.ema_decay is not None)
        if self._ckpt.has_checkpoint():  # auto-resume (ref: tf_utils.py:198-203)
            self._ckpt.restore(state)
            print(f"[trainer] resumed from step {state.step}")
        elif self.config.checkpoint_path:
            self._warm_start(state)
        self.state = state
        return state

    def warm_start_source(self, backbone_prefix: str) -> Dict[str, np.ndarray]:
        """`checkpoint_path` through the importer of `checkpoint_format`:
        flax-flat names, flax layouts."""
        cfg = self.config
        if cfg.checkpoint_format == "torch":
            return torch_vgg_to_flat(load_torch_checkpoint(cfg.checkpoint_path), backbone_prefix=backbone_prefix,
                                     bgr_to_rgb=cfg.checkpoint_bgr_to_rgb)
        if cfg.checkpoint_format == "tf":
            from .tf_checkpoint import TFCheckpointReader, slim_vgg_to_flat

            return slim_vgg_to_flat(TFCheckpointReader(cfg.checkpoint_path).load_all(),
                                    source_scope=cfg.checkpoint_model_scope or "vgg_16",
                                    backbone_prefix=backbone_prefix)
        if cfg.checkpoint_format == "caffe":
            from .caffe_import import caffe_vgg_to_flat, parse_caffemodel

            return caffe_vgg_to_flat(parse_caffemodel(cfg.checkpoint_path), backbone_prefix=backbone_prefix,
                                     bgr_to_rgb=cfg.checkpoint_bgr_to_rgb)
        if cfg.checkpoint_format == "orbax":
            return load_orbax_npz(cfg.checkpoint_path)["params"]
        raise ValueError(f"unknown checkpoint_format {cfg.checkpoint_format!r}")

    @torch.no_grad()
    def _warm_start(self, state: TrainState) -> None:
        """Overlay `checkpoint_path`'s tensors on the parameters, in place."""
        cfg = self.config
        flat = to_jax_params(self.model, state.params.items())
        # RON trees scope the VGG under 'backbone/'; SSD keeps its convs at top level
        backbone_prefix = "backbone" if any(k.startswith("backbone/") for k in flat) else ""
        rename = {"backbone": cfg.checkpoint_model_scope} if cfg.checkpoint_model_scope else None
        out, restored = overlay_params(flat, self.warm_start_source(backbone_prefix),
                                       exclude_scopes=cfg.checkpoint_exclude_scopes, rename_map=rename)
        for name, value in from_jax_params({k: out[k] for k in restored}, {}).items():
            state.params[name].copy_(value)

    def make_batches(self, epochs=None) -> Iterator[Dict[str, np.ndarray]]:
        """Host batches from the TFRecord shards of `data.file_pattern` in
        `data.dataset_dir` (JAX `trainer.py:231-256`): uint8 working canvases
        (a quarter of the upload), read and decoded on background threads."""
        cfg = self.config
        files = list_shards(cfg.data.dataset_dir, cfg.data.file_pattern)
        if not files:
            raise FileNotFoundError(f"no shards matching {cfg.data.file_pattern!r} in {cfg.data.dataset_dir!r}")
        pcfg = PipelineConfig(
            batch_size=cfg.data.batch_size,
            working_shape=cfg.data.working_shape,
            max_boxes=cfg.data.max_boxes,
            shuffle=cfg.data.shuffle,
            keep_difficult=cfg.data.keep_difficult,
            num_workers=cfg.data.num_workers,
            worker_index=cfg.data.worker_index,
            seed=cfg.seed,
            cache_decoded=cfg.data.cache_decoded,
            output_dtype="uint8",
        )
        return PrefetchIterator(batch_iterator(files, pcfg, epochs=epochs))

    def generator(self, step: int) -> torch.Generator:
        """The step's generator: augmentation draws first, then the
        forward's (SSD's dropout), then the loss's (RON's)."""
        return torch.Generator(device=self.device).manual_seed(step_seed(self.config.seed, step))

    def augment(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """A device batch of the working canvas -> the train step's batch."""
        image01 = batch["image01"]
        if image01.dtype == torch.uint8:  # uint8 transport: 4x less to upload
            image01 = image01.float() / 255.0
        image, boxes, labels, valid = train_augment_batch(
            generator, image01.float(), batch["gt_boxes"].float(), batch["gt_labels"], batch["gt_valid"],
            self.preprocess_config)
        return {"image": image, "gt_labels": labels, "gt_boxes": boxes, "gt_valid": valid}

    def step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """One step on a device batch of the working canvas, with the
        generator of `state.step`."""
        gen = self.generator(state.step)
        return self._train_step(state, self.augment(batch, gen), gen)

    def train(self, max_steps: Optional[int] = None, batches=None) -> TrainState:
        cfg = self.config
        max_steps = max_steps or cfg.max_steps
        print_config(cfg)
        state = self.init_state()
        writer = MetricsWriter(cfg.model_dir)
        tb = None
        if cfg.tensorboard:
            from ..utils.tensorboard import TensorBoardWriter

            tb = TensorBoardWriter(cfg.model_dir)
            print(f"[trainer] TensorBoard events -> {tb.path}"
                  + ("" if has_pil() else " (scalars only: PIL, which encodes the images, is not installed)"))
        timer = StepTimer()
        last_save_time = time.time()
        it = DevicePrefetcher(batches if batches is not None else self.make_batches(), self.device)
        try:
            while state.step < max_steps:
                try:
                    batch = next(it)
                except StopIteration:
                    print("[trainer] input exhausted")
                    break
                state, metrics = self.step(state, batch)
                timer.tick()
                step = state.step

                if cfg.log_every_steps and step % cfg.log_every_steps == 0:
                    loss = float(metrics["loss/total"])
                    if not np.isfinite(loss):
                        raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
                    scalars = {k: float(v) for k, v in metrics.items()}
                    scalars["images_per_sec"] = timer.images_per_sec(cfg.data.batch_size)
                    writer.write(step, scalars)
                    if tb is not None:
                        tb.scalars(scalars, step)
                    print(f"[trainer] step {step} loss {loss:.4f} ({scalars['images_per_sec']:.1f} img/s)")

                if cfg.dump_debug_images_every and step % cfg.dump_debug_images_every == 0:
                    self._dump_debug_image(batch, step, tb)

                if cfg.max_host_rss_gb and _host_rss_gb() > cfg.max_host_rss_gb:
                    # a controlled restart point: save THIS step, exit 75 for a supervisor
                    self._ckpt.save(step, state)
                    self._ckpt.wait()
                    print(f"[trainer] host RSS {_host_rss_gb():.1f} GB > {cfg.max_host_rss_gb} GB limit: "
                          f"saved step {step}, exiting 75 (EX_TEMPFAIL) for supervisor restart")
                    raise SystemExit(75)

                time_due = time.time() - last_save_time > cfg.save_interval_secs
                if step % cfg.save_every_steps == 0 or time_due or step >= max_steps:
                    self._ckpt.save(step, state)
                    last_save_time = time.time()
        finally:
            self._ckpt.wait()
            writer.close()
            if tb is not None:
                tb.close()
        return state

    def _dump_debug_image(self, batch: Dict[str, torch.Tensor], step: int, tb=None) -> None:
        """Sample 0 of the augmented batch that step `step` trained on, with
        its gt boxes (ref: eval_ron_network.py:240-247, draw_toolbox.py:48-101):
        the augmentation re-run with that step's generator (the one of
        state step `step - 1`), so the image is what the step saw; to
        TensorBoard too when it is on. Drawing needs PIL: without it the
        trainer says so once and draws nothing."""
        from ..utils.visualization import draw_boxes

        if not has_pil():
            if not self._said_no_pil:
                print("[trainer] debug images need PIL, which is not installed: none are written")
                self._said_no_pil = True
            return
        aug = self.augment(batch, self.generator(step - 1))
        img01 = np.clip(unwhiten(aug["image"][0].float()).cpu().numpy(), 0.0, 1.0)
        labels = torch.where(aug["gt_valid"][0], aug["gt_labels"][0], 0).cpu().numpy()
        debug_dir = os.path.join(self.config.model_dir, "debug")
        os.makedirs(debug_dir, exist_ok=True)
        pil = draw_boxes(img01, aug["gt_boxes"][0].cpu().numpy(), labels)
        pil.save(os.path.join(debug_dir, f"step_{step:06d}.jpg"))
        if tb is not None:
            tb.image("train/augmented_gt", np.asarray(pil), step)
