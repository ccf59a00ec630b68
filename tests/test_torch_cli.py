"""The port's CLI: `import-ckpt` (torch and TF sources) into a model dir that
`inspect-ckpt`, `CheckpointManager.restore_eval` and a Trainer read, held
against the JAX package's importers and `inspect_params` (`infer`:
`test_torch_infer.py`; `bench`: `test_torch_bench.py`). `--debug-nans` parses in
both CLIs; under it a tiny CPU train step from a checkpoint with one NaN
weight raises FloatingPointError naming the weight's module, and without
it no hook is installed, anomaly detection stays off and the same step
stops at the trainer's finite check.

The tiny RON keeps RON-320's widths: an imported model dir holds a ~750 MB
step-0 state, removed when each test ends."""

import dataclasses
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ron_tensorflow_tpu import cli as jax_cli
from ron_tensorflow_tpu.train import checkpoint as jax_ckpt
from ron_tensorflow_tpu.train import tf_checkpoint as jax_tf

from ron_tensorflow_tpu_torch import cli
from ron_tensorflow_tpu_torch.config import TrainConfig
from ron_tensorflow_tpu_torch.models import get_network, layers
from ron_tensorflow_tpu_torch.train.checkpoint import CheckpointManager
from ron_tensorflow_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from ron_tensorflow_tpu_torch.train.state import create_train_state
from ron_tensorflow_tpu_torch.tools.synthetic_data import make_dataset
from ron_tensorflow_tpu_torch.train.trainer import Trainer
from ron_tensorflow_tpu_torch.weights import jax_names, to_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_warm_start import seeded_vgg  # noqa: E402

MODEL = "ron_tiny_vgg"


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def run(argv, capsys):
    capsys.readouterr()
    cli.main(argv)
    return capsys.readouterr().out.splitlines()


def imported(model_dir):
    """(params, batch stats) of the model dir's newest step, flax names."""
    model, _ = get_network(MODEL)
    variables, step = CheckpointManager(model_dir).restore_eval()
    return (to_jax_params(model, variables["params"].items()), to_jax_params(model, variables["batch_stats"].items()),
            step)


def test_import_torch_then_inspect_and_resume(tmp_path, capsys):
    sd = seeded_vgg(11)
    torch.save(sd, tmp_path / "vgg.pth")
    model_dir = str(tmp_path / "model")
    out = run(["import-ckpt", "--format", "torch", "--source", str(tmp_path / "vgg.pth"), "--model", MODEL,
               "--model-dir", model_dir, "--bgr-to-rgb"], capsys)
    assert out[-1] == f"imported torch checkpoint -> {model_dir} (step 0)"
    params, stats, step = imported(model_dir)
    want = jax_ckpt.torch_vgg_to_flat(sd, bgr_to_rgb=True)
    assert step == 0 and len(want) == 30
    for k, v in want.items():
        assert np.array_equal(params[k], v), k

    lines = run(["inspect-ckpt", "--model", MODEL, "--model-dir", model_dir], capsys)
    assert lines[0] == "step: 0"
    assert lines[1:] == jax_ckpt.inspect_params(jax_ckpt.unflatten_params(params))
    assert len(lines) - 1 == len(params) == len(list(get_network(MODEL)[0].parameters()))
    conv1 = run(["inspect-ckpt", "--model", MODEL, "--model-dir", model_dir, "--pattern", "conv1_"], capsys)
    assert conv1[1:] == jax_ckpt.inspect_params(jax_ckpt.unflatten_params(params), "conv1_") and len(conv1) == 5

    # a bf16 Trainer with the train preset's optimizer resumes from the imported step
    trainer = Trainer(dataclasses.replace(TrainConfig(), model=MODEL, model_dir=model_dir, tensorboard=False),
                      device="cpu")
    st = trainer.init_state()
    assert st.step == 0 and trainer.model.dtype == torch.bfloat16
    resumed = to_jax_params(trainer.model, st.params.items())
    assert all(np.array_equal(resumed[k], v) for k, v in params.items())
    assert all(np.array_equal(to_jax_params(trainer.model, st.batch_stats.items())[k], v) for k, v in stats.items())


def test_import_tf_ron_graph_takes_its_batchnorm_statistics(tmp_path, capsys):
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(12)
    scope = "ron_320_vgg/reverse_module/block4_reverse_conv_left"
    tensors = {
        "ron_320_vgg/conv1/conv1_1/weights": rng.standard_normal((3, 3, 3, 64)),
        "ron_320_vgg/conv1/conv1_1/biases": rng.standard_normal(64),
        f"{scope}/weights": rng.standard_normal((3, 3, 512, 512)),
        f"{scope}/BatchNorm/gamma": rng.uniform(0.5, 1.5, 512),
        f"{scope}/BatchNorm/beta": rng.standard_normal(512),
        f"{scope}/BatchNorm/moving_mean": rng.standard_normal(512),
        f"{scope}/BatchNorm/moving_variance": rng.uniform(0.5, 1.5, 512),
        "ron_320_vgg/reverse_module/block5_reverse_deconv_right/weights": rng.standard_normal((2, 2, 512, 512)),
        "ron_320_vgg/reverse_module/block5_reverse_deconv_right/biases": rng.standard_normal(512),
    }
    tensors = {k: v.astype(np.float32) for k, v in tensors.items()}
    tf1 = tf.compat.v1
    graph = tf1.Graph()
    with graph.as_default():
        for name, value in tensors.items():
            tf1.Variable(value, name=name)
        tf1.train.get_or_create_global_step()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            prefix = tf1.train.Saver().save(sess, str(tmp_path / "ron.ckpt"), write_meta_graph=False)
    model_dir = str(tmp_path / "model")
    run(["import-ckpt", "--format", "tf", "--source", prefix, "--model", MODEL, "--model-dir", model_dir], capsys)
    params, stats, _ = imported(model_dir)
    want_p, want_s = jax_tf.slim_ron_to_flat(jax_tf.TFCheckpointReader(prefix).load_all())
    assert len(want_p) == 7 and len(want_s) == 2
    for got, want in ((params, want_p), (stats, want_s)):
        for k, v in want.items():
            assert np.array_equal(got[k], v), k
    # the rest keeps the seeded init of `import-ckpt` (seed 0)
    model, _ = get_network(MODEL)
    init = create_train_state(model, make_optimizer(OptimizerConfig(), model), torch.Generator().manual_seed(0))
    init_p = to_jax_params(model, init.params.items())
    init_s = to_jax_params(model, init.batch_stats.items())
    assert all(np.array_equal(params[k], init_p[k]) for k in params if k not in want_p)
    assert all(np.array_equal(stats[k], init_s[k]) for k in stats if k not in want_s)


def test_restore_eval_reads_parameters_and_statistics_only(tmp_path):
    """Whatever optimizer wrote the checkpoint; the EMA with use_ema where
    the checkpoint has one, else the parameters."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(layers.Conv(3, 4, norm=True), layers.ConvTranspose(4, 4))
    for name, ema in (("adam", True), ("momentum", False)):
        state = create_train_state(model, make_optimizer(OptimizerConfig(optimizer=name), model),
                                   generator=torch.Generator().manual_seed(1), ema=ema)
        if ema:
            for t in state.ema_params.values():
                t.add_(1.0)
        for t in state.batch_stats.values():
            t.uniform_()
        state.step = 4
        mgr = CheckpointManager(str(tmp_path / name))
        mgr.save(4, state)
        mgr.reload()
        for use_ema in (False, True):
            variables, step = mgr.restore_eval(use_ema=use_ema)
            want = state.ema_params if use_ema and ema else state.params
            assert step == 4 and variables.keys() == {"params", "batch_stats"}
            assert all(torch.equal(variables["params"][k], want[k]) for k in want)
            assert all(torch.equal(variables["batch_stats"][k], v) for k, v in state.batch_stats.items())
    assert set(jax_names(model).values()) >= {"0/conv/kernel", "1/deconv_kernel"}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_eval()


NAN_WEIGHT = "backbone.conv4_1.conv.weight"


def test_debug_nans_parses_in_both_clis():
    argv = ["--debug-nans", "train", "--preset", "ron_320", "--model-dir", "m", "data.batch_size=2"]
    for parser in (jax_cli.build_parser(), cli.build_parser()):
        args = parser.parse_args(argv)
        assert args.debug_nans and args.command == "train" and args.overrides == ["data.batch_size=2"]
        assert not parser.parse_args(argv[1:]).debug_nans


def nan_train_argv(tmp_path, flag):
    """A one-step CPU `train` of the tiny RON on synthetic records, from a
    step-0 checkpoint whose NAN_WEIGHT is NaN."""
    records = make_dataset(str(tmp_path / "records"), n_train=4, n_test=1, canvas=64)
    model_dir = tmp_path / f"nan_{flag}"
    model, _ = get_network(MODEL)
    with torch.no_grad():
        model.get_parameter(NAN_WEIGHT).fill_(float("nan"))
    CheckpointManager(str(model_dir)).save(0, create_train_state(model, make_optimizer(TrainConfig().optimizer,
                                                                                        model)))
    return (["--device", "cpu"] + (["--debug-nans"] if flag else [])
            + ["train", "--model-dir", str(model_dir), "--dataset-dir", records, f"model={MODEL}",
               "data.file_pattern=synth_train_*.tfrecord", "data.batch_size=2", "data.working_shape=[64, 64]",
               "bfloat16=false", "max_steps=1", "log_every_steps=1", "tensorboard=false"])


@pytest.mark.parametrize("flag", [True, False], ids=["--debug-nans", "without the flag"])
def test_nan_weight_in_a_train_step(tmp_path, flag):
    msg = "NaN in the output of module 'backbone.conv4_1' (Conv)" if flag else "non-finite loss at step 1: nan"
    with pytest.raises(FloatingPointError, match=re.escape(msg)):
        cli.main(nan_train_argv(tmp_path, flag))
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("flag", [True, False], ids=["--debug-nans", "without the flag"])
def test_debug_nans_hooks_only_under_the_flag(tmp_path, monkeypatch, flag):
    seen = {}

    def train(self, *a, **k):
        seen["hooked"] = [bool(m._forward_hooks) for m in self.model.modules()]
        seen["anomaly"] = torch.is_anomaly_enabled()

    monkeypatch.setattr(Trainer, "train", train)
    cli.main(nan_train_argv(tmp_path, flag))
    assert seen["anomaly"] == flag and not torch.is_anomaly_enabled()
    assert len(seen["hooked"]) > 50 and set(seen["hooked"]) == {flag}
