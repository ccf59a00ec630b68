"""The port's Trainer end to end on the CPU (tiny RON, synthetic host
batches), its checkpoints, config and input pipeline; the configs against
the JAX package's.

The tiny RON keeps RON-320's channel widths (94 M parameters): a checkpoint
with the momentum trace is ~750 MB, so these runs save rarely, keep one, and
each test removes its model directory.
"""

import dataclasses
import itertools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from ron_tensorflow_tpu import config as jax_config
from ron_tensorflow_tpu.data import pipeline as jax_pipeline
from ron_tensorflow_tpu.data.tfrecord import list_shards as jax_list_shards

from ron_tensorflow_tpu_torch.config import DataConfig, MatchConfig, TrainConfig, apply_overrides
from ron_tensorflow_tpu_torch.data.convert import convert_voc
from ron_tensorflow_tpu_torch.data.pipeline import DevicePrefetcher, PrefetchIterator
from ron_tensorflow_tpu_torch.data.preprocess import PreprocessConfig
from ron_tensorflow_tpu_torch.losses.ssd import SsdLossConfig
from ron_tensorflow_tpu_torch.models import layers
from ron_tensorflow_tpu_torch.models.spec import SSD_300_SPEC
from ron_tensorflow_tpu_torch.train.checkpoint import CheckpointManager
from ron_tensorflow_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from ron_tensorflow_tpu_torch.train.state import create_train_state
from ron_tensorflow_tpu_torch.train.trainer import Trainer, step_seed
from ron_tensorflow_tpu_torch.utils.tensorboard import read_events

B, CANVAS, G = 2, 96, 4


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, emptied when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: its CPU steps share the
    cores with the other test workers, and eight spinning threads a worker
    slow all of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_config(tmp_path, **kw):
    cfg = apply_overrides(TrainConfig(), [
        "model=ron_tiny_vgg", f"model_dir={tmp_path}/model", f"data.batch_size={B}", "bfloat16=false",
        "max_steps=4", "log_every_steps=1", "save_every_steps=1000", "max_to_keep=1",
        "optimizer.learning_rate=0.001", "optimizer.learning_rate_decay_type=fixed",
    ])
    return dataclasses.replace(cfg, **kw)


def record_saves(trainer):
    """Record the steps the trainer saves at instead of writing them."""
    steps = []
    trainer._ckpt.save = lambda step, state: steps.append(step)
    return steps


def host_batches(dtype=np.uint8, nan=False):
    """The same host batch every step: uint8 (or float [0, 1]) images at the
    working canvas, two gts on the first image and one on the second."""
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (B, CANVAS, CANVAS, 3)).astype(np.uint8)
    boxes = np.zeros((B, G, 4), np.float32)
    boxes[0, :2] = ((0.2, 0.2, 0.7, 0.6), (0.5, 0.1, 0.9, 0.5))
    boxes[1, 0] = (0.1, 0.3, 0.8, 0.9)
    batch = {"image01": image if dtype == np.uint8 else (image / 255.0).astype(np.float32),
             "gt_boxes": boxes, "gt_labels": np.array([[3, 7, 0, 0], [12, 0, 0, 0]], np.int32),
             "gt_valid": np.array([[True, True, False, False], [True, False, False, False]])}
    if nan:
        batch["image01"] = np.full((B, CANVAS, CANVAS, 3), np.nan, np.float32)
    while True:
        yield batch


def params_of(state):
    return {k: v.detach().clone() for k, v in state.params.items()}


def test_trainer_end_to_end_resume_equals_an_unbroken_run(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=2, dump_debug_images_every=2)
    straight = Trainer(dataclasses.replace(cfg, model_dir=str(tmp_path / "straight"), save_every_steps=1), device="cpu")
    saves = record_saves(straight)
    s2 = straight.train(batches=host_batches())
    assert s2.step == 2 and saves == [1, 2]
    rows = [json.loads(line) for line in open(tmp_path / "straight" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss/total"]) for r in rows)
    assert {"grad_norm", "images_per_sec", "counts/positives"} <= rows[-1].keys()
    assert os.listdir(tmp_path / "straight" / "debug") == ["step_000002.jpg"]

    first = Trainer(dataclasses.replace(cfg, max_steps=1, dump_debug_images_every=0), device="cpu")
    assert first.train(batches=host_batches()).step == 1
    resumed = Trainer(dataclasses.replace(cfg, dump_debug_images_every=0), device="cpu")
    s2b = resumed.train(batches=host_batches())
    assert s2b.step == 2
    a, b = params_of(s2), params_of(s2b)
    for k in a:  # the per-step generators make the resumed run draw what the unbroken one drew
        assert torch.equal(a[k], b[k]), k
    for k, v in s2.opt_state.items():
        if isinstance(v, list):
            assert all(torch.equal(x, y) for x, y in zip(v, s2b.opt_state[k]))


def test_trainer_float32_transport_equals_uint8(tmp_path):
    runs = {}
    for name, dtype in (("u8", np.uint8), ("f32", np.float32)):
        t = Trainer(tiny_config(tmp_path, model_dir=str(tmp_path / name), max_steps=1), device="cpu")
        record_saves(t)
        runs[name] = params_of(t.train(batches=host_batches(dtype)))
    for k in runs["u8"]:  # x / 255 on the host or on the device: the same floats
        assert torch.equal(runs["u8"][k], runs["f32"][k]), k


def test_trainer_time_based_save(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=2, save_every_steps=1000, save_interval_secs=0.0)
    t = Trainer(cfg, device="cpu")
    saves = record_saves(t)
    t.train(batches=host_batches())
    assert saves == [1, 2]  # due by time after every step


def test_trainer_host_rss_guard_saves_and_exits_75(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=50, save_every_steps=1000, max_host_rss_gb=0.001)
    t = Trainer(cfg, device="cpu")
    with pytest.raises(SystemExit) as e:
        t.train(batches=host_batches())
    assert e.value.code == 75 and t._ckpt.latest_step() == 1
    t2 = Trainer(dataclasses.replace(cfg, max_host_rss_gb=0.0, max_steps=2), device="cpu")
    assert t2.train(batches=host_batches()).step == 2


def test_trainer_nan_guard(tmp_path):
    t = Trainer(tiny_config(tmp_path, max_steps=3), device="cpu")
    record_saves(t)
    with pytest.raises(FloatingPointError, match="non-finite loss at step 1"):
        t.train(batches=host_batches(np.float32, nan=True))


def test_trainer_tensorboard_is_announced_once_and_input_can_end(tmp_path, capsys):
    """With tensorboard=True the trainer names its event file once; the
    file holds the scalars of metrics.jsonl at the same steps (as float32),
    and the debug image, which needs no PIL."""
    t = Trainer(tiny_config(tmp_path, tensorboard=True, max_steps=5, dump_debug_images_every=2), device="cpu")
    record_saves(t)
    host = next(host_batches())
    state = t.train(batches=iter([host, host]))
    out = capsys.readouterr().out
    assert state.step == 2 and "input exhausted" in out
    assert out.count("TensorBoard events -> ") == 1
    files = [f for f in os.listdir(t.config.model_dir) if f.startswith("events.out.tfevents")]
    assert len(files) == 1
    events = read_events(os.path.join(t.config.model_dir, files[0]))
    rows = [json.loads(line) for line in open(os.path.join(t.config.model_dir, "metrics.jsonl"))]
    scalars = {e["step"]: e["scalars"] for e in events if e["scalars"]}
    assert sorted(scalars) == [r["step"] for r in rows] == [1, 2]
    for r in rows:
        want = {k: float(np.float32(v)) for k, v in r.items() if k not in ("step", "time")}
        assert scalars[r["step"]] == want
    images = [(e["step"], list(e["images"])) for e in events if e["images"]]
    assert images == [(2, ["train/augmented_gt"])]


def test_trainer_defaults_to_cuda_and_refuses_what_is_not_ported(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Trainer(tiny_config(tmp_path))
    # s2d_stem is ported: it constructs, and wins over fuse_block1 (JAX trainer.py:79-83)
    t = Trainer(tiny_config(tmp_path, s2d_stem=True, fuse_block1=True), device="cpu")
    assert t.model.backbone.s2d_stem and not t.model.backbone.fuse_block1
    # a mesh over more ranks than the run has (one process here) raises JAX's message
    with pytest.raises(ValueError, match=r"mesh shape \(2, 1\) needs 2 devices, have 1"):
        Trainer(tiny_config(tmp_path, mesh_shape=(2, 1)), device="cpu")
    # K-B only on a CUDA device: the CPU model keeps block 1 unfused
    t = Trainer(tiny_config(tmp_path, bfloat16=True, fuse_block1=True), device="cpu")
    assert not t.model.backbone.fuse_block1 and t.model.dtype == torch.bfloat16
    # SSD: the SSD model, its hard-negative loss at the match threshold and the 'ssd' augmentation
    t = Trainer(tiny_config(tmp_path, model="ssd_300_vgg", match=MatchConfig(0.5, 0.5), fuse_block1=True),
                device="cpu")
    assert type(t.model).__name__ == "SSD" and t.spec is SSD_300_SPEC and not t.model.fuse_block1
    assert t.loss_config == SsdLossConfig(num_classes=21, match_threshold=0.5)
    assert t.preprocess_config == PreprocessConfig(out_shape=(300, 300), variant="ssd")
    assert Trainer(tiny_config(tmp_path, model="ssd_512_vgg", augment_variant="ron"),
                   device="cpu").preprocess_config.variant == "ron"


def test_make_batches_reads_records(tmp_path):
    """`make_batches` reads the TFRecord shards of `data` as JAX's
    `Trainer.make_batches` does (`batch_iterator` with the trainer's
    pipeline, uint8 canvases): the same samples in the same order, gts
    exact, pixels bit-equal (the port's decoder against cv2's)."""
    voc = os.path.join(os.path.dirname(__file__), "fixtures", "voc_mini", "VOC2007")
    records = str(tmp_path / "records")
    for name in ("voc_2007_train_0", "voc_2007_train_1"):
        assert convert_voc(voc, records, name) == 8
    data = DataConfig(dataset_dir=records, batch_size=3, working_shape=(48, 80), max_boxes=8, cache_decoded=True)
    t = Trainer(tiny_config(tmp_path, data=data, seed=7), device="cpu")
    got = list(itertools.islice(t.make_batches(epochs=1), 6))
    pcfg = jax_pipeline.PipelineConfig(batch_size=3, working_shape=(48, 80), max_boxes=8, shuffle=True,
                                       keep_difficult=False, seed=7, cache_decoded=True, output_dtype="uint8")
    want = list(jax_pipeline.batch_iterator(jax_list_shards(records, data.file_pattern), pcfg, epochs=1))
    assert len(got) == len(want) == 5  # 16 samples in full batches of 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["image01"].dtype == np.uint8
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    with pytest.raises(FileNotFoundError, match="no shards"):
        Trainer(tiny_config(tmp_path, data=dataclasses.replace(data, dataset_dir=str(tmp_path))),
                device="cpu").make_batches()


def test_step_seeds_differ_by_step_and_seed():
    seeds = {step_seed(s, k) for s in range(3) for k in range(100)}
    assert len(seeds) == 300 and all(0 <= x < 2 ** 63 for x in seeds)


def test_checkpoint_round_trip_and_retention(tmp_path):
    """The whole TrainState (step, parameters, BN buffers, momentum trace,
    EMA) through `torch.save` and back, on a small model; keep-N retention."""
    def small_state(seed):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(layers.Conv(3, 4, norm=True), layers.ConvTranspose(4, 4))
        return create_train_state(model, make_optimizer(OptimizerConfig(), model),
                                  generator=torch.Generator().manual_seed(seed), ema=True), model

    state, model = small_state(0)
    for t in state.opt_state["trace"] + list(state.batch_stats.values()):
        t.uniform_()
    state.step = 7
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in (5, 6, 7):
        mgr.save(step, state)
    assert mgr.all_steps() == [6, 7] and mgr.latest_step() == 7 and mgr.has_checkpoint()
    fresh, fresh_model = small_state(1)
    before = fresh.params["0.conv.weight"]
    mgr.restore(fresh)
    assert fresh.params["0.conv.weight"] is before  # copied into the model's own tensors
    assert dict(fresh_model.named_parameters())["0.conv.weight"] is before
    saved, back = state.state_dict(), fresh.state_dict()
    assert back["step"] == 7
    for part in ("params", "batch_stats", "ema_params"):
        assert all(torch.equal(back[part][k], saved[part][k]) for k in saved[part])
    assert all(torch.equal(x, y) for x, y in zip(back["opt_state"]["trace"], saved["opt_state"]["trace"]))
    assert back["opt_state"]["count"] == saved["opt_state"]["count"]
    mgr.wait()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)
    other = create_train_state(model, make_optimizer(OptimizerConfig(optimizer="adam"), model), ema=True)
    with pytest.raises(KeyError, match="optimizer"):
        mgr.restore(other)


def test_configs_equal_the_jax_package_defaults():
    def fields(cfg):
        return {k: (tuple(v) if isinstance(v, list) else v) for k, v in dataclasses.asdict(cfg).items()}

    assert fields(DataConfig()) == fields(jax_config.DataConfig())
    assert fields(MatchConfig()) == fields(jax_config.MatchConfig())
    ours, theirs = fields(TrainConfig()), fields(jax_config.TrainConfig())
    assert ours.keys() == theirs.keys()
    assert ours == theirs
    cfg = apply_overrides(TrainConfig(), ["optimizer.momentum=0.5", "data.working_shape=[64, 64]", "bfloat16=no"])
    assert cfg.optimizer.momentum == 0.5 and tuple(cfg.data.working_shape) == (64, 64) and cfg.bfloat16 is False
    with pytest.raises(KeyError):
        apply_overrides(TrainConfig(), ["nope=1"])


def test_prefetchers_pass_items_and_errors_through():
    assert list(PrefetchIterator(iter(range(5)))) == list(range(5))

    def broken():
        yield {"a": np.ones(3)}
        raise ValueError("bad shard")

    it = DevicePrefetcher(broken(), "cpu")
    first = next(it)
    assert torch.is_tensor(first["a"]) and first["a"].device.type == "cpu"
    with pytest.raises(ValueError, match="bad shard"):
        next(it)
