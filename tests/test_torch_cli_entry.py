"""The port's CLI from a VOCdevkit to a trained checkpoint and its mAP, on
the CPU: `convert-data` -> `train` (two f32 steps of the tiny RON) ->
`eval` -> `realtime-eval`, on the workspace of `tests/test_cli.py`. On the
same weights (the port's checkpoint written as an orbax checkpoint for the
JAX CLI) the JAX CLI's `eval` and `realtime-eval` give the same mAP07,
mAP12, APs and loss/* within 1e-5, and the same detections (the port
decoding with its own decoder, JAX with cv2). `wait_for_checkpoints` with
`max_evals`, an unknown override, and the trained RON-320 through
`realtime-eval` over `tests/fixtures/voc_mini` against the JAX rows in
`tests/fixtures/voc_mini_ref.npz`.

The tiny RON keeps RON-320's widths (94 M parameters, a ~750 MB train
state): the workspace trains once, saves once and is removed at the end."""

import json
import os
import pickle
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu import cli as jax_cli
from ron_tensorflow_tpu.data import convert as jax_convert
from ron_tensorflow_tpu.eval import StreamingEvaluator as JaxStreamingEvaluator
from ron_tensorflow_tpu.train import checkpoint as jax_ckpt

from ron_tensorflow_tpu_torch import cli
from ron_tensorflow_tpu_torch.eval import StreamingEvaluator
from ron_tensorflow_tpu_torch.models import get_network
from ron_tensorflow_tpu_torch.train.checkpoint import CheckpointManager
from ron_tensorflow_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from ron_tensorflow_tpu_torch.train.state import create_train_state
from ron_tensorflow_tpu_torch.weights import from_jax_params, load_trained_fixture, to_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_cli import TRAIN_OVERRIDES, _make_vocdevkit  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"
MODEL = "ron_tiny_vgg"
# test_cli.py's recipe on one device, TensorBoard off
PORT_TRAIN = [o for o in TRAIN_OVERRIDES if not o.startswith("mesh_shape")] + ["tensorboard=false"]
EVAL = [f"model={MODEL}", "data.file_pattern=voc_2007_train_*.tfrecord", "data.batch_size=3", "data.max_boxes=8",
        "select_top_k=64", "keep_top_k=16", "objectness_threshold=0.0", "bfloat16=false"]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def to_jax_model_dir(port_dir, jax_dir, model_name=MODEL):
    """The newest checkpoint of a port model dir as an orbax checkpoint that
    the JAX CLI restores (params and batch stats, at the same step)."""
    model, _ = get_network(model_name)
    variables, step = CheckpointManager(port_dir).restore_eval()
    trees = {k: jax_ckpt.unflatten_params({n: np.asarray(v) for n, v in
                                           to_jax_params(model, variables[k].items()).items()})
             for k in ("params", "batch_stats")}
    mgr = jax_ckpt.CheckpointManager(jax_dir)
    mgr.save(step, trees)
    mgr.wait()
    return step


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_entry")
    voc = _make_vocdevkit(root / "VOCdevkit")
    ws = {"voc_root": str(voc), "records": str(root / "records"), "model_dir": str(root / "model"),
          "jax_model_dir": str(root / "jax_model"), "root": root}
    cli.main(["convert-data", "--voc-root", str(voc / "VOC2007"), "--output-dir", ws["records"],
              "--output-name", "voc_2007_train"])
    cli.main(["--device", "cpu", "train", "--model-dir", ws["model_dir"], "--dataset-dir", ws["records"]]
             + PORT_TRAIN)
    to_jax_model_dir(ws["model_dir"], ws["jax_model_dir"])
    yield ws
    shutil.rmtree(root, ignore_errors=True)


def test_convert_and_train_outputs(workspace, tmp_path):
    shards = sorted(os.listdir(workspace["records"]))
    assert shards == ["voc_2007_train_000.tfrecord"]
    jax_convert.convert_voc(os.path.join(workspace["voc_root"], "VOC2007"), str(tmp_path), "voc_2007_train")
    assert (Path(workspace["records"]) / shards[0]).read_bytes() == (tmp_path / shards[0]).read_bytes()
    assert CheckpointManager(workspace["model_dir"]).all_steps() == [2]
    with open(os.path.join(workspace["model_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss/total"]) for r in rows)


def ron_eval_draws(bi, shape):
    """The draws JAX's evaluator gives the RON loss of batch bi:
    PRNGKey(bi) -> (k_obj, k_cls) -> two uniforms (losses/ron.py:90)."""
    return torch.as_tensor(np.stack([np.asarray(jax.random.uniform(k, shape)) for k in
                                     jax.random.split(jax.random.PRNGKey(bi))]))


def recording(monkeypatch, cls, results):
    """Keep what `cls.run` returns, call by call."""
    run_ = cls.run

    def wrapped(self, *a, **kw):
        out = run_(self, *a, **kw)
        results.append(out)
        return out

    monkeypatch.setattr(cls, "run", wrapped)


def same_loss_draws(monkeypatch):
    batch_loss = StreamingEvaluator.batch_loss

    def with_jax_draws(self, out, gt_labels, gt_boxes, bi, draws=None, **kw):
        return batch_loss(self, out, gt_labels, gt_boxes, bi, ron_eval_draws(bi, tuple(out.logits.shape[:2])), **kw)

    monkeypatch.setattr(StreamingEvaluator, "batch_loss", with_jax_draws)


def test_eval_matches_jax_cli(workspace, capsys, monkeypatch):
    """8 images in batches of 3 (the last padded and masked): the port's
    `eval` and JAX's on the same weights, the same loss draws."""
    same_loss_draws(monkeypatch)
    got, want = [], []
    recording(monkeypatch, StreamingEvaluator, got)
    recording(monkeypatch, JaxStreamingEvaluator, want)
    out = run(cli.main, ["--device", "cpu", "eval", "--model-dir", workspace["model_dir"], "--dataset-dir",
                         workspace["records"]] + EVAL, capsys)
    jout = run(jax_cli.main, ["eval", "--model-dir", workspace["jax_model_dir"], "--dataset-dir",
                              workspace["records"]] + EVAL, capsys)
    assert "[eval] restored step 2" in out and "[eval] restored step 2" in jout
    assert got[0][3]["images"] == 8
    assert_same_scores(got[0], want[0], out, jout)


def assert_same_scores(got, want, out, jout):
    """mAP07, mAP12, every AP07 and loss/* within TOL; the printed lines equal."""
    (map07, map12, aps, stats), (jmap07, jmap12, japs, jstats) = got, want
    assert stats["images"] == jstats["images"]
    assert abs(map07 - jmap07) <= TOL and abs(map12 - jmap12) <= TOL
    assert aps.keys() == japs.keys() and all(abs(aps[c] - japs[c]) <= TOL for c in aps)
    losses = sorted(k for k in jstats if k.startswith("loss/"))
    assert losses == sorted(k for k in stats if k.startswith("loss/")) and len(losses) == 4
    for k in losses:
        assert abs(stats[k] - jstats[k]) <= TOL * max(1.0, abs(jstats[k])), (k, stats[k], jstats[k])
    printed = lambda text: [l for l in text.splitlines() if l.startswith(("mAP", "loss/", "  AP07"))]  # noqa: E731
    assert printed(out) == printed(jout)


def test_realtime_eval_matches_jax_cli(workspace, capsys):
    outs = {}
    for name, main, model_dir in (("port", cli.main, workspace["model_dir"]),
                                  ("jax", jax_cli.main, workspace["jax_model_dir"])):
        out_dir = str(workspace["root"] / f"rt_{name}")
        argv = ["realtime-eval", "--model", MODEL, "--model-dir", model_dir, "--voc-root", workspace["voc_root"],
                "--objectness-threshold", "0.0", "--output-dir", out_dir]
        text = run(main, (["--device", "cpu"] if name == "port" else []) + argv, capsys)
        with open(os.path.join(out_dir, "detections.pkl"), "rb") as f:
            outs[name] = (text, pickle.load(f))
    (text, boxes), (jtext, jboxes) = outs["port"], outs["jax"]
    assert "restored step 2" in text
    assert [l for l in text.splitlines() if l.startswith(("AP for", "Mean AP"))] == \
        [l for l in jtext.splitlines() if l.startswith(("AP for", "Mean AP"))]
    for c in range(len(jboxes)):
        for got, want in zip(boxes[c], jboxes[c]):
            assert got.shape == np.asarray(want).shape
            np.testing.assert_allclose(got, want, atol=2e-3)


def test_wait_for_checkpoints_with_max_evals(workspace, tmp_path, capsys, monkeypatch):
    """Continuous eval (ref: eval_ssd_network.py wait_for_checkpoints): a
    checkpoint that appears while eval waits is evaluated; max_evals stops."""
    watch = tmp_path / "watch"
    shutil.copytree(workspace["model_dir"], watch, copy_function=os.link)

    def fake_sleep(secs):  # the training job writes step 5 meanwhile
        if not (watch / "5").exists():
            shutil.copytree(watch / "2", watch / "5", copy_function=os.link)

    monkeypatch.setattr("time.sleep", fake_sleep)
    out = run(cli.main, ["--device", "cpu", "eval", "--model-dir", str(watch), "--dataset-dir", workspace["records"]]
              + EVAL + ["max_batches=1", "report_loss=false", "wait_for_checkpoints=true", "max_evals=2",
                        "eval_interval_secs=0"], capsys)
    assert "restored step 2" in out and "restored step 5" in out
    assert out.count("mAP (VOC07 metric)") == 2


def test_unknown_override_rejected(workspace):
    for sub in ("train", "eval"):
        with pytest.raises(KeyError, match="no_such_field"):
            cli.main(["--device", "cpu", sub, "--model-dir", "/nonexistent", "--dataset-dir", workspace["records"],
                      "no_such_field=1"])
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "eval", "--bogus-flag"])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    for argv in (["train"], ["eval"], ["realtime-eval", "--model-dir", "m", "--voc-root", "v"]):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv + (["model=ron_tiny_vgg"] if argv[0] != "realtime-eval" else []))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """RON-320 with the trained weights of e2e_parity_trained.npz in a port
    model dir (and as an orbax checkpoint for the JAX CLI), and the voc_mini
    records."""
    root = tmp_path_factory.mktemp("trained")
    model, _ = get_network("ron_320_vgg")
    model.load_state_dict(from_jax_params(*load_trained_fixture(str(FIXTURES / "e2e_parity_trained.npz"))))
    state = create_train_state(model, make_optimizer(OptimizerConfig(optimizer="sgd"), model))
    CheckpointManager(str(root / "model")).save(0, state)
    del model, state
    to_jax_model_dir(str(root / "model"), str(root / "jax_model"), "ron_320_vgg")
    cli.main(["convert-data", "--voc-root", str(FIXTURES / "voc_mini" / "VOC2007"), "--output-dir",
              str(root / "records"), "--output-name", "voc_2007_test"])
    yield root
    shutil.rmtree(root, ignore_errors=True)


def test_trained_eval_over_voc_mini_matches_jax_cli(trained, capsys, monkeypatch):
    """RON-320, f32, the eval preset's detection config, 8 images in
    batches of 3: the port's `eval` and JAX's, on the same weights and loss
    draws."""
    same_loss_draws(monkeypatch)
    got, want = [], []
    recording(monkeypatch, StreamingEvaluator, got)
    recording(monkeypatch, JaxStreamingEvaluator, want)
    argv = ["--preset", "ron_320", "--dataset-dir", str(trained / "records"), "data.batch_size=3", "bfloat16=false"]
    out = run(cli.main, ["--device", "cpu", "eval", "--model-dir", str(trained / "model")] + argv, capsys)
    jout = run(jax_cli.main, ["eval", "--model-dir", str(trained / "jax_model")] + argv, capsys)
    assert_same_scores(got[0], want[0], out, jout)
    assert got[0][3]["images"] == 8 and got[0][0] > 0.1


def test_trained_realtime_eval_over_voc_mini_matches_jax_rows(trained, capsys):
    """RON-320 with the trained weights, f32, through `realtime-eval` over
    the fixture VOCdevkit: the detections JAX's realtime evaluator wrote
    (voc_mini_ref.npz), equal counts and classes, scores and boxes within
    2e-3; the same mean AP."""
    out = run(cli.main, ["--device", "cpu", "realtime-eval", "--model-dir", str(trained / "model"),
                         "--voc-root", str(FIXTURES / "voc_mini"), "--output-dir", str(trained / "out")], capsys)
    with open(trained / "out" / "detections.pkl", "rb") as f:
        all_boxes = pickle.load(f)
    ref = np.load(FIXTURES / "voc_mini_ref.npz")
    rows = [(c, ii, row) for c, per_image in enumerate(all_boxes) for ii, r in enumerate(per_image)
            for row in np.asarray(r).reshape(-1, 5)]
    assert len(rows) == len(ref["rt/rows"]) > 0
    assert [c for c, _, _ in rows] == ref["rt/cls"].tolist() and [i for _, i, _ in rows] == ref["rt/image"].tolist()
    np.testing.assert_allclose(np.stack([r for _, _, r in rows]), ref["rt/rows"], atol=2e-3)
    assert f"Mean AP = {float(ref['rt/map']):.4f}" in out
