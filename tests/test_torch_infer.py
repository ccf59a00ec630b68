"""The port's `cli infer` against the JAX package's, on the CPU: the tiny
RON from one set of numpy-made weights in a port model dir and as an orbax
checkpoint for the JAX CLI, over the eight JPEGs of
`tests/fixtures/voc_mini`. Seeded weights on whitened pixels (+-128) give
outputs in the thousands (VGG has no BatchNorm, and the heads' run on
seeded running statistics), so the predictors, which are linear, are
scaled on these images to class and objectness logits of standard
deviation 3 and locations of 0.5: decisive softmaxes, so that the realtime
head keeps boxes at its published thresholds, and boxes that are not all
clipped.

- The detections `infer` draws equal those of JAX's own pipeline on the
  same files (PIL decode, `tf1_bilinear_resize`, /255, `whiten`,
  `RealtimeDetector`): equal counts and labels, scores and boxes within
  1e-5, as `test_torch_realtime.py` holds the head alone on equal
  outputs: both sides run float32 and the port's decoder equals PIL's bit
  for bit on these baseline JPEGs, so only the forward's summation order
  differs, a few 1e-6 of an output's largest magnitude here.
- It prints the JAX CLI's lines, word for word, and writes one picture an
  image.
- PNGs and progressive JPEGs (tests/fixtures/image_formats) take the same
  path with PIL and cv2 unimportable, against JAX's pipeline on the same
  files (PIL decode).
- A file the port's decoders do not take (a GIF) raises ValueError naming
  it; without `--device` it runs on the card and raises here.
"""

import shutil
import sys
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ron_tensorflow_tpu import cli as jax_cli
from ron_tensorflow_tpu.data.preprocess import whiten as jax_whiten
from ron_tensorflow_tpu.data.resize import tf1_bilinear_resize as jax_resize
from ron_tensorflow_tpu.inference.detector import RealtimeConfig as JaxRealtimeConfig
from ron_tensorflow_tpu.inference.detector import RealtimeDetector as JaxRealtimeDetector
from ron_tensorflow_tpu.models import get_network as jax_get_network
from ron_tensorflow_tpu.train.checkpoint import unflatten_params

from ron_tensorflow_tpu_torch import cli
from ron_tensorflow_tpu_torch.data.decode import decode_jpeg_raw
from ron_tensorflow_tpu_torch.data.preprocess import whiten
from ron_tensorflow_tpu_torch.data.resize import tf1_bilinear_resize
from ron_tensorflow_tpu_torch.models import get_network
from ron_tensorflow_tpu_torch.models.testing import seeded_flax_params
from ron_tensorflow_tpu_torch.train.checkpoint import CheckpointManager
from ron_tensorflow_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from ron_tensorflow_tpu_torch.train.state import create_train_state
from ron_tensorflow_tpu_torch.weights import from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_cli_entry import to_jax_model_dir  # noqa: E402

MODEL = "ron_tiny_vgg"
VOC_MINI = Path(__file__).resolve().parent / "fixtures" / "voc_mini" / "VOC2007" / "JPEGImages"
IMAGE_FORMATS = Path(__file__).resolve().parent / "fixtures" / "image_formats"
TOL = 1e-5
# the standard deviations the seeded predictors are scaled to, on the fixture images
HEAD_STD = {"_cls/pred/": ("logits", 3.0), "_objectness/score/": ("objness_logits", 3.0),
            "_box/pred/": ("locations", 0.5)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """(port model dir, orbax model dir, flax params, flax batch stats)."""
    root = tmp_path_factory.mktemp("infer")
    model, spec = get_network(MODEL)
    params, stats = seeded_flax_params(model, seed=21, gain=np.sqrt(2.0))
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    pixels = np.stack([tf1_bilinear_resize(decode_jpeg_raw(Path(p).read_bytes()), spec.img_shape) for p in images()])
    with torch.no_grad():
        out = model(whiten(torch.from_numpy(pixels) / 255.0))
    for k in params:
        for part, (field, std) in HEAD_STD.items():
            if part in k:
                params[k] = params[k] * np.float32(std / float(getattr(out, field).std()))
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    CheckpointManager(str(root / "model")).save(0, create_train_state(model, make_optimizer(
        OptimizerConfig(optimizer="sgd"), model)))
    del model
    to_jax_model_dir(str(root / "model"), str(root / "jax_model"))
    yield root, params, stats
    shutil.rmtree(root, ignore_errors=True)


def images():
    return sorted(str(p) for p in VOC_MINI.glob("*.jpg"))


def run_infer(argv, capsys):
    """The port's `cli infer`: (printed lines, what `infer_images` returned)."""
    results = []
    real = cli.infer_images
    with mock.patch.object(cli, "infer_images", lambda *a, **k: results.append(real(*a, **k)) or results[-1]):
        capsys.readouterr()
        cli.main(argv)
    return capsys.readouterr().out.splitlines(), results[0]


def jax_pipeline(params, stats, paths, objectness_threshold):
    """`ron_tensorflow_tpu/cli.py::cmd_infer`'s detections, image by image."""
    model, spec = jax_get_network(MODEL)
    variables = {"params": unflatten_params(params), "batch_stats": unflatten_params(stats)}
    det = JaxRealtimeDetector(model, spec, JaxRealtimeConfig.for_spec(spec, objectness_threshold=objectness_threshold))
    out = []
    for path in paths:
        raw = np.asarray(Image.open(path).convert("RGB"))
        img01 = jax_resize(raw, spec.img_shape) / 255.0
        scores, labels, boxes, valid = det(variables, jnp.expand_dims(jax_whiten(jnp.asarray(img01)), 0))
        v = np.asarray(valid[0])
        out.append((np.asarray(scores[0])[v], np.asarray(labels[0])[v], np.asarray(boxes[0])[v]))
    return out


@pytest.mark.parametrize("threshold", [None, "0.5"], ids=["published", "lower"])
def test_infer_matches_jax(model_dirs, tmp_path, capsys, threshold):
    root, params, stats = model_dirs
    paths = images()
    assert len(paths) == 8
    flag = [] if threshold is None else ["--objectness-threshold", threshold]
    out_dir = str(tmp_path / "pictures")
    lines, got = run_infer(["--device", "cpu", "infer", "--model", MODEL, "--model-dir", str(root / "model"),
                            "--output-dir", out_dir, *flag, *paths], capsys)
    want = jax_pipeline(params, stats, paths, 0.95 if threshold is None else float(threshold))
    assert len(got) == len(want) == 8
    counts = []
    for (path, scores, labels, boxes, picture), (ws, wl, wb), i in zip(got, want, range(8)):
        assert path == paths[i] and picture == str(Path(out_dir) / f"{i}.jpg") and Path(picture).is_file()
        assert len(scores) == len(ws), path
        np.testing.assert_array_equal(labels, wl)
        np.testing.assert_allclose(scores, ws, rtol=0, atol=TOL)
        np.testing.assert_allclose(boxes, wb, rtol=0, atol=TOL)
        counts.append(len(scores))
    assert sum(counts) >= 8 and max(counts) >= 2, counts  # the head keeps boxes: the comparison bites
    assert lines == [f"{p}: {n} detections -> {out_dir}/{i}.jpg" for i, (p, n) in enumerate(zip(paths, counts))]
    # the JAX CLI on the same files and weights prints the same lines
    capsys.readouterr()
    jax_cli.main(["infer", "--model", MODEL, "--model-dir", str(root / "jax_model"), "--output-dir", out_dir, *flag,
                  *paths])
    assert capsys.readouterr().out.splitlines() == lines


def test_infer_takes_png_and_progressive_jpeg_without_pil(model_dirs, tmp_path, capsys, monkeypatch):
    """The fixture PNGs (a Pillow-written picture and the 16-bit gray one,
    where PIL's route clips) and progressive JPEGs, with PIL and cv2
    unimportable in the port's run: JAX's pipeline's detections (PIL
    decode), and one picture each that the port's decoder reads back."""
    root, params, stats = model_dirs
    paths = [str(IMAGE_FORMATS / n) for n in ("voc_000001.png", "gray16.png", "prog_420.jpg", "prog_odd.jpg")]
    want = jax_pipeline(params, stats, paths, 0.5)
    out_dir = tmp_path / "pictures"
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    lines, got = run_infer(["--device", "cpu", "infer", "--model", MODEL, "--model-dir", str(root / "model"),
                            "--output-dir", str(out_dir), "--objectness-threshold", "0.5", *paths], capsys)
    assert len(got) == len(want) == len(lines) == 4
    for (path, scores, labels, boxes, picture), (ws, wl, wb) in zip(got, want):
        assert len(scores) == len(ws), path
        np.testing.assert_array_equal(labels, wl)
        np.testing.assert_allclose(scores, ws, rtol=0, atol=TOL)
        np.testing.assert_allclose(boxes, wb, rtol=0, atol=TOL)
        assert decode_jpeg_raw(Path(picture).read_bytes()).shape == (64, 64, 3)
    assert sum(len(g[1]) for g in got) >= 2


def test_infer_rejects_a_file_the_decoder_does_not_take(model_dirs, tmp_path):
    root, _, _ = model_dirs
    gif = tmp_path / "frame.gif"
    Image.fromarray(np.zeros((40, 60, 3), np.uint8)).save(gif)
    with pytest.raises(ValueError, match="frame.gif"):
        cli.main(["--device", "cpu", "infer", "--model", MODEL, "--model-dir", str(root / "model"), "--output-dir",
                  str(tmp_path / "out"), images()[0], str(gif)])
    assert (tmp_path / "out" / "0.jpg").is_file() and not (tmp_path / "out" / "1.jpg").exists()


def test_infer_runs_on_the_card_by_default(model_dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root, _, _ = model_dirs
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["infer", "--model", MODEL, "--model-dir", str(root / "model"), "--output-dir", str(tmp_path),
                  images()[0]])
