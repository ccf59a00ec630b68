"""Data-parallel eval of the port on the CPU (gloo ranks): the streaming
evaluator on a (2, 1) mesh against one process, and the CLI's `eval` under
`python -m torch.distributed.run` against the JAX CLI's `mesh_shape=[2, 1]`
run.

Each data rank runs the Detector on its rows of every batch, the scores and
boxes are gathered to rank 0 in row order, and rank 0 matches and
accumulates: mAP07, mAP12, every AP and every class's scores and TP/FP
marks are exactly the one-process run's (ties break the same way); the
RON loss of each batch (the global batch's, each rank's share summed)
within 1e-6 relative. The gts are the one-process detections' best boxes,
so that the tiny RON's seeded weights score true positives.
"""

import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ron_tensorflow_tpu import cli as jax_cli
from ron_tensorflow_tpu.train import checkpoint as jax_ckpt

from ron_tensorflow_tpu_torch import cli
from ron_tensorflow_tpu_torch.models import get_network
from ron_tensorflow_tpu_torch.models.testing import seeded_flax_params
from ron_tensorflow_tpu_torch.parallel.testing import free_port, run_ranks
from ron_tensorflow_tpu_torch.train.checkpoint import CheckpointManager
from ron_tensorflow_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from ron_tensorflow_tpu_torch.train.state import create_train_state
from ron_tensorflow_tpu_torch.weights import from_jax_params, to_jax_params

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
sys.path.insert(0, str(TESTS))
from test_cli import _make_vocdevkit  # noqa: E402
from torch_dist_workers import eval_batches, evaluation, tiny_evaluator  # noqa: E402

RUN_TIMEOUT = 300  # seconds for one multi-process run, start-up included


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_eval")
    model, _ = get_network("ron_tiny_vgg")
    state = from_jax_params(*seeded_flax_params(model, 3))
    torch.save(state, root / "weights.pt")
    yield root, state
    shutil.rmtree(root, ignore_errors=True)


def test_evaluator_on_two_ranks_equals_one_process(tiny):
    root, _ = tiny
    weights = str(root / "weights.pt")
    ev = tiny_evaluator(weights, None)
    # gts: each image's best one-process detection, so that the run scores TPs
    probe = eval_batches({"labels": np.ones((12, 2), np.int32), "boxes": np.zeros((12, 2, 4), np.float32)})
    labels, boxes = np.zeros((12, 2), np.int32), np.zeros((12, 2, 4), np.float32)
    with torch.inference_mode():
        for i, b in enumerate(probe):
            image = torch.as_tensor(b["image"]).float() / 255.0
            from ron_tensorflow_tpu_torch.data.preprocess import whiten

            scores, dets = ev.detector(whiten(image))
            flat = scores.reshape(scores.shape[0], -1).argmax(-1)
            for r in range(scores.shape[0]):
                c, k = divmod(int(flat[r]), scores.shape[2])
                labels[4 * i + r, 0], boxes[4 * i + r, 0] = c + 1, dets[r, c, k].numpy()
    np.savez(root / "gts.npz", labels=labels, boxes=boxes)
    want = evaluation(ev, eval_batches({"labels": labels, "boxes": boxes}))
    res = run_ranks("torch_dist_workers:eval_worker", 2, dict(weights=weights, gts_file=str(root / "gts.npz")),
                    timeout=RUN_TIMEOUT, pythonpath=[str(TESTS)])
    map07, map12, aps, stats, classes = res[0]
    assert (map07, map12, aps) == want[:3]
    assert classes.keys() == want[4].keys()
    for c, (n_gt, *arrays) in want[4].items():
        assert classes[c][0] == n_gt
        assert all(np.array_equal(a, b) for a, b in zip(classes[c][1:], arrays)), c
    n_tp = sum(int(v[2].sum()) for v in want[4].values())
    assert n_tp > 0 and stats["images"] == want[3]["images"] == 11
    for k in ("loss/total", "loss/objectness", "loss/classification", "loss/localization"):
        np.testing.assert_allclose(stats[k], want[3][k], rtol=1e-6, err_msg=k)
    assert res[1][:3] == (None, None, {})  # rank 1 accumulates nothing


def torchrun(argv, timeout):
    """`python -m torch.distributed.run` with argv; its process group killed
    if it outlasts `timeout`. Returns (exit code, output)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc-per-node", "2",
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()), *argv]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"torch.distributed.run outlasted {timeout} s:\n{out[-4000:]}")
    return proc.returncode, out


@pytest.mark.slow
def test_cli_eval_under_torch_distributed_run_equals_jax_cli_mesh(tiny, capsys):
    """8 images in batches of 4 over 2 ranks (`--device cpu`: gloo) against
    the JAX CLI's eval on `mesh_shape=[2, 1]` (two of its eight CPU
    devices), the same weights: the printed mAP07, mAP12 and APs equal."""
    root, state = tiny
    voc = _make_vocdevkit(root / "VOCdevkit")
    records, port_dir, jax_dir = root / "records", root / "model", root / "jax_model"
    cli.main(["convert-data", "--voc-root", str(voc / "VOC2007"), "--output-dir", str(records),
              "--output-name", "voc_2007_train"])
    model, _ = get_network("ron_tiny_vgg")
    model.load_state_dict(state)
    CheckpointManager(str(port_dir)).save(3, create_train_state(model, make_optimizer(OptimizerConfig(), model)))
    trees = {"params": jax_ckpt.unflatten_params(to_jax_params(model, model.named_parameters())),
             "batch_stats": jax_ckpt.unflatten_params(to_jax_params(model, model.named_buffers()))}
    mgr = jax_ckpt.CheckpointManager(str(jax_dir))
    mgr.save(3, trees)
    mgr.wait()
    overrides = ["model=ron_tiny_vgg", "data.file_pattern=voc_2007_train_*.tfrecord", "data.batch_size=4",
                 "data.max_boxes=8", "select_top_k=64", "keep_top_k=16", "objectness_threshold=0.0",
                 "bfloat16=false", "report_loss=false", "mesh_shape=[2, 1]"]
    rc, out = torchrun(["-m", "ron_tensorflow_tpu_torch.cli", "--device", "cpu", "eval", "--model-dir", str(port_dir),
                        "--dataset-dir", str(records), *overrides], RUN_TIMEOUT)
    assert rc == 0, out[-4000:]
    capsys.readouterr()
    jax_cli.main(["eval", "--model-dir", str(jax_dir), "--dataset-dir", str(records), *overrides])
    jout = capsys.readouterr().out
    printed = lambda text: [l for l in text.splitlines() if l.startswith(("mAP", "  AP07"))]  # noqa: E731
    assert out.count("mAP (VOC07 metric)") == 1  # rank 0 alone prints
    assert printed(out) == printed(jout) and len(printed(jout)) > 2
