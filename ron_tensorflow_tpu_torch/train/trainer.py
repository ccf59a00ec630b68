"""The trainer: config in, trained checkpoints out.

Port of `ron_tensorflow_tpu/train/trainer.py`. Each step:
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

K-B (the fused block-1 kernel, with its recompute backward) is on for
`fuse_block1`, a bf16 model, a CUDA device and a shape
`fused_block1_supported` takes (RON-320, SSD-300 and SSD-512 alike), in
every rank of a multi-process run: a rank's forward is a one-device
forward. (The JAX trainer turns it off under a mesh, trainer.py:84-100,
only because Pallas calls do not partition under GSPMD.)

Distribution (JAX trainer.py:258-300, 310-342, 390-438): in a run of
several processes (torch.distributed initialized, e.g. by the CLI under
`python -m torch.distributed.run`), or with `mesh_shape`, the model runs
on a (data, model) mesh (`parallel.make_mesh(mesh_shape)`, whose size must
be the world's). `data.batch_size` is each data rank's local batch; the
input is sharded by data rank (`num_workers`, `worker_index` default to
the data axis); images/s counts the global batch. The state is initialized
(or restored, or warm-started) whole on every rank, rank 0's is broadcast
and each rank keeps its 'model' slice. The step's draws are the global
batch's, so N ranks train on what one process would. Only rank 0 writes
metrics, TensorBoard and, with one process only, debug images; the
host-RSS guard runs with one process only; the time-based save decision is
rank 0's, broadcast every 16 steps; a save gathers the 'model' slices, rank
0 writes the one-process checkpoint and every rank waits for it (a
checkpoint from any mesh restores in one process). Each rank keeps its own
`input_state_{rank}.json` for the Grain pipeline.

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
`make_batches` (the ported `batch_iterator`, or with `data.use_grain` the
Grain-equivalent `GrainBatches`, whose input position is saved beside each
checkpoint and restored on resume), or takes host batches. With the Grain
input, each step's record keys (indices into the shards' records) go to
`input_keys.jsonl` in `model_dir` (`input_keys_{rank}.jsonl` for each rank
of several processes), one line a step, appended across restarts: what a
resumed run read can be checked against an unbroken run.

`s2d_stem` runs block 1 as the phase-output stem (`models/vgg.py::
s2d_block1`) where `s2d_stem_supported` takes the model's shape, and wins
over `fuse_block1`; on another shape the model stays plain, as in the JAX
trainer (trainer.py:79-83).
"""

from __future__ import annotations

import importlib.util
import json
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
from ..models import get_network, get_spec, shard_model
from ..models.vgg import s2d_stem_supported
from ..ops.encode import TargetEncoder
from ..parallel.collectives import barrier, broadcast_int
from ..parallel.mesh import make_mesh, sharded_names, world_size
from ..parallel.multihost import batch_rows, host_local_to_global, process_info, with_rows
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
from .state import (
    TrainState,
    create_train_state,
    gathered_state_dict,
    make_eval_step,
    make_train_step,
    shard_state_dict,
)


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


class Trainer:
    """`Trainer(config, device="cuda")`: raises without a card unless the
    caller asks for `device="cpu"`. In a multi-process run, `device` is
    this rank's (the CLI gives `cuda:LOCAL_RANK`)."""

    def __init__(self, config: TrainConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.rank, self.n_proc = process_info()
        # a mesh for a multi-process run, or when one is asked for: (world, 1) by default
        self.mesh = make_mesh(config.mesh_shape) if config.mesh_shape or world_size() > 1 else None
        dtype = torch.bfloat16 if config.bfloat16 else torch.float32
        ssd = config.model.startswith("ssd")
        spec = get_spec(config.model)
        # s2d_stem wins over fuse_block1; on a shape it does not take, block 1 stays plain (trainer.py:79-83)
        s2d = config.s2d_stem and s2d_stem_supported(*spec.img_shape)
        fuse = (not config.s2d_stem and config.fuse_block1 and config.bfloat16 and self.device.type == "cuda"
                and fused_block1_supported(*spec.img_shape))
        kwargs = {} if ssd else {"bn_fast_normalize": config.bn_fast_normalize}
        self.model, self.spec = get_network(config.model, dtype=dtype, fuse_block1=fuse, s2d_stem=s2d, **kwargs)
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
        self._train_step = make_train_step(self.model, self.encoder, self.tx, self.loss_config, config.ema_decay,
                                           self.mesh)
        self.sharded = sharded_names(self.model, self.mesh) if self.mesh is not None else {}
        self.eval_step = make_eval_step(self.model, self.encoder, self.loss_config)
        self._ckpt = CheckpointManager(config.model_dir, max_to_keep=config.max_to_keep)
        self.state: Optional[TrainState] = None
        self._said_no_pil = False

    # ------------------------------------------------------------------ #

    def init_state(self) -> TrainState:
        """Parameters initialized as flax does from `config.seed` (drawn on
        the CPU); then the newest checkpoint in `model_dir` if there is one,
        else the warm start from `checkpoint_path` if one is given. On a
        mesh: rank 0's state on every rank, each keeping its 'model' slice
        (`shard_model`, `shard_state_dict`)."""
        self.model.to(self.device)
        ema = self.config.ema_decay is not None
        state = create_train_state(self.model, self.tx, torch.Generator().manual_seed(self.config.seed), ema=ema)
        if self._ckpt.has_checkpoint():  # auto-resume (ref: tf_utils.py:198-203)
            self._ckpt.restore(state)
            if self.rank == 0:
                print(f"[trainer] resumed from step {state.step}")
        elif self.config.checkpoint_path:
            self._warm_start(state)
        if self.mesh is not None:
            whole = state.state_dict()
            shard_model(self.model, self.mesh)
            state = create_train_state(self.model, self.tx, ema=ema)
            state.load_state_dict(shard_state_dict(whole, self.mesh, self.sharded, self.device))
        self.state = state
        return state

    def save(self, step: int, state: TrainState) -> None:
        """Checkpoint `state` as step `step`: on a mesh of several processes,
        the 'model' slices gathered, rank 0 writing, every rank waiting."""
        if self.n_proc == 1:
            self._ckpt.save(step, state)
            return
        whole = gathered_state_dict(state, self.mesh, self.sharded)
        if self.rank == 0:
            self._ckpt.save(step, whole)
        barrier()

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
        workers, index = cfg.data.num_workers, cfg.data.worker_index
        if self.n_proc > 1 and workers == 1:  # one input shard per data rank
            workers, index = self.mesh.data_size, self.mesh.data_index
        pcfg = PipelineConfig(
            batch_size=cfg.data.batch_size,
            working_shape=cfg.data.working_shape,
            max_boxes=cfg.data.max_boxes,
            shuffle=cfg.data.shuffle,
            keep_difficult=cfg.data.keep_difficult,
            num_workers=workers,
            worker_index=index,
            seed=cfg.seed,
            cache_decoded=cfg.data.cache_decoded,
            output_dtype="uint8",
        )
        if cfg.data.use_grain:
            from ..data.grain_pipeline import GrainBatches

            return GrainBatches(files, pcfg, epochs=epochs)
        return PrefetchIterator(batch_iterator(files, pcfg, epochs=epochs))

    def generator(self, step: int) -> torch.Generator:
        """The step's generator: augmentation draws first, then the
        forward's (SSD's dropout), then the loss's (RON's)."""
        return torch.Generator(device=self.device).manual_seed(step_seed(self.config.seed, step))

    def augment(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """A device batch of the working canvas -> the train step's batch
        (a rank's rows of a global batch stay those rows: the draws are the
        global batch's)."""
        image01 = batch["image01"]
        if image01.dtype == torch.uint8:  # uint8 transport: 4x less to upload
            image01 = image01.float() / 255.0
        offset, b, total = batch_rows(batch)
        image, boxes, labels, valid = train_augment_batch(
            generator, image01.float(), batch["gt_boxes"].float(), batch["gt_labels"], batch["gt_valid"],
            self.preprocess_config, rows=None if b == total else (offset, total))
        return with_rows({"image": image, "gt_labels": labels, "gt_boxes": boxes, "gt_valid": valid}, batch)

    def step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """One step on a device batch of the working canvas, with the
        generator of `state.step`."""
        gen = self.generator(state.step)
        return self._train_step(state, self.augment(batch, gen), gen)

    def train(self, max_steps: Optional[int] = None, batches=None) -> TrainState:
        cfg = self.config
        max_steps = max_steps or cfg.max_steps
        primary = self.rank == 0
        if primary:
            print_config(cfg)
        state = self.init_state()
        writer = MetricsWriter(cfg.model_dir) if primary else None
        tb = None
        if cfg.tensorboard and primary:
            from ..utils.tensorboard import TensorBoardWriter

            tb = TensorBoardWriter(cfg.model_dir)
            print(f"[trainer] TensorBoard events -> {tb.path}"
                  + ("" if has_pil() else " (scalars only: PIL, which encodes the images, is not installed)"))
        timer = StepTimer()
        last_save_time = time.time()
        it = batches if batches is not None else self.make_batches()
        # Grain input position: each rank its own file (its shard's stream)
        suffix = "" if self.n_proc == 1 else f"_{self.rank}"
        input_state_path = os.path.join(cfg.model_dir, f"input_state{suffix}.json")
        keys_log = None
        if state.step > 0 and hasattr(it, "restore_state_json") and os.path.exists(input_state_path):
            with open(input_state_path) as f:
                it.restore_state_json(f.read())
            print(f"[trainer] rank {self.rank}: input pipeline position restored")
        if self.n_proc == 1 and not hasattr(it, "state_json"):
            # upload one batch ahead; not for a resumable input (read-ahead would
            # put the saved position past the consumed one) nor for several processes
            it = DevicePrefetcher(it, self.device)
            place = None
        else:
            mesh = self.mesh

            def place(host_batch):
                keep = {k: host_batch[k] for k in ("image01", "gt_boxes", "gt_labels", "gt_valid")}
                if mesh is None:
                    return {k: torch.as_tensor(v).to(self.device) for k, v in keep.items()}
                return host_local_to_global(keep, mesh, self.device)
        global_batch = cfg.data.batch_size * (self.mesh.data_size if self.mesh is not None else 1)

        def save_input_state():
            if hasattr(it, "state_json"):  # every rank: its own shard's position
                with open(input_state_path, "w") as f:
                    f.write(it.state_json())

        try:
            if hasattr(it, "last_keys"):
                os.makedirs(cfg.model_dir, exist_ok=True)
                keys_log = open(os.path.join(cfg.model_dir, f"input_keys{suffix}.jsonl"), "a", buffering=1)
            while state.step < max_steps:
                try:
                    batch = next(it)
                except StopIteration:
                    print("[trainer] input exhausted")
                    break
                if place is not None:
                    batch = place(batch)
                state, metrics = self.step(state, batch)
                timer.tick()
                step = state.step
                if keys_log is not None:
                    keys_log.write(json.dumps({"step": step, "record_keys": [int(k) for k in it.last_keys]}) + "\n")

                if cfg.log_every_steps and step % cfg.log_every_steps == 0:
                    loss = float(metrics["loss/total"])
                    if not np.isfinite(loss):
                        raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
                    if primary:
                        scalars = {k: float(v) for k, v in metrics.items()}
                        scalars["images_per_sec"] = timer.images_per_sec(global_batch)
                        writer.write(step, scalars)
                        if tb is not None:
                            tb.scalars(scalars, step)
                        print(f"[trainer] step {step} loss {loss:.4f} ({scalars['images_per_sec']:.1f} img/s)")

                if (cfg.dump_debug_images_every and primary and self.n_proc == 1
                        and step % cfg.dump_debug_images_every == 0):
                    self._dump_debug_image(batch, step, tb)

                if cfg.max_host_rss_gb and self.n_proc == 1 and _host_rss_gb() > cfg.max_host_rss_gb:
                    # a controlled restart point: save THIS step, exit 75 for a supervisor
                    self._ckpt.save(step, state)
                    save_input_state()
                    self._ckpt.wait()
                    print(f"[trainer] host RSS {_host_rss_gb():.1f} GB > {cfg.max_host_rss_gb} GB limit: "
                          f"saved step {step}, exiting 75 (EX_TEMPFAIL) for supervisor restart")
                    raise SystemExit(75)

                time_due = time.time() - last_save_time > cfg.save_interval_secs
                if self.n_proc > 1:
                    # every rank must take the same decision: rank 0's, broadcast every 16 steps
                    time_due = bool(broadcast_int(time_due if primary else 0)) if step % 16 == 0 else False
                if step % cfg.save_every_steps == 0 or time_due or step >= max_steps:
                    self.save(step, state)
                    save_input_state()
                    last_save_time = time.time()
        finally:
            self._ckpt.wait()
            if keys_log is not None:
                keys_log.close()
            if writer is not None:
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
