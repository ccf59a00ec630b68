"""The port's dress rehearsal (`tools/dress_rehearsal.py`) and detection-knob
A/B (`tools/ab_detection_config.py`) against the JAX tools of the same
names (repo-root `tools/`, loaded by path; they draw with PIL's ImageDraw
and encode with Pillow).

- The same seed gives the same draws, sparse and crowded: image sizes,
  labels, boxes, `difficult` and `truncated` flags as each side's records
  parse are bit-equal; the VOC XML and `test.txt` are byte-equal; records
  and JPEGs of images drawn only with rectangles, bars and triangles are
  byte-equal (the port's encoder writes Pillow's bytes, and those shapes
  are Pillow's pixels); images with an ellipse or a ring agree within a
  mean absolute difference of 2.5 levels (JPEG spreads an edge pixel over
  its block).
- Triangles and bars equal `ImageDraw`'s pixels; a ring differs only on
  pixels that touch one of Pillow's two ellipse edges.
- The seeded torch VGG-16 checkpoint, and the TrainConfig for each model
  and crowding, equal the JAX tool's (its `main` run up to the Trainer).
- Both evaluators, on a tiny rehearsal dir with the same tiny RON weights
  on both sides (f32), give JAX's mAP07 within 1e-6.
- `main` runs end to end on the CPU (tiny RON, 2 steps) and writes the JAX
  tool's keys; the A/B prints its nine lines, and its variants that run
  the same keep-mask version on the CPU agree exactly.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import pickle
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from ron_tensorflow_tpu import config as jax_config
from ron_tensorflow_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ron_tensorflow_tpu.data.pipeline import PrefetchIterator as JaxPrefetchIterator
from ron_tensorflow_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from ron_tensorflow_tpu.data.preprocess import whiten_np as jax_whiten_np
from ron_tensorflow_tpu.eval import RealtimeEvaluator as JaxRealtimeEvaluator
from ron_tensorflow_tpu.eval import StreamingEvaluator as JaxStreamingEvaluator
from ron_tensorflow_tpu.inference.detector import DetectionConfig as JaxDetectionConfig
from ron_tensorflow_tpu.inference.detector import RealtimeConfig as JaxRealtimeConfig
from ron_tensorflow_tpu.models.ron import RON as JaxRON
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.train.checkpoint import unflatten_params

from ron_tensorflow_tpu_torch.data.jpeg import decode_rgb
from ron_tensorflow_tpu_torch.data.pipeline import parse_voc_example
from ron_tensorflow_tpu_torch.data.tfrecord import read_records
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC
from ron_tensorflow_tpu_torch.models.testing import seeded_flax_params
from ron_tensorflow_tpu_torch.tools import ab_detection_config as ab
from ron_tensorflow_tpu_torch.tools import dress_rehearsal as dr
from ron_tensorflow_tpu_torch.tools.synthetic_data import fill_ellipse, fill_polygon, fill_rectangle
from ron_tensorflow_tpu_torch.train.checkpoint import CheckpointManager
from ron_tensorflow_tpu_torch.weights import from_jax_params

REPO = Path(__file__).resolve().parent.parent
JAX_TOOL = REPO / "tools" / "dress_rehearsal.py"
MEAN_ABS_TOL = 2.5
MAP_TOL = 1e-6  # the evaluators' tolerance (tests/test_torch_eval.py)
N_TRAIN, N_TEST = 10, 8
TINY_TEST = 12  # test images of the tiny rehearsal dir the evaluators score
EXACT_SHAPES = {"rect", "triangle", "bar"}  # drawn with Pillow's pixels


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_dress_rehearsal", JAX_TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("rehearsal")
    tool = jax_tool()
    for crowded in (False, True):
        tool.make_dataset(str(root / f"jax_{crowded}"), N_TRAIN, N_TEST, seed=0, crowded=crowded)
        dr.make_dataset(str(root / f"port_{crowded}"), N_TRAIN, N_TEST, seed=0, crowded=crowded)
    return root


def exact_shapes_only(labels) -> bool:
    return all(dr.SHAPES[(int(c) - 1) % 5] in EXACT_SHAPES for c in labels)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("crowded", [False, True])
def test_records_are_the_jax_tools(datasets, crowded, split):
    """Sizes, labels, boxes and flags bit-equal; the bytes too where every
    shape is drawn with Pillow's pixels; else the images within 2.5 levels."""
    name = f"synth_{split}_000.tfrecord"
    jax_records = list(read_records(str(datasets / f"jax_{crowded}" / "records" / name)))
    port_records = list(read_records(str(datasets / f"port_{crowded}" / "records" / name)))
    assert len(port_records) == len(jax_records) == (N_TRAIN if split == "train" else N_TEST)
    kinds = set()
    for jr, pr in zip(jax_records, port_records):
        j, p = parse_voc_example(jr), parse_voc_example(pr)
        assert set(p) == set(j)
        for key in j:
            if key != "jpeg":
                np.testing.assert_array_equal(np.asarray(p[key]), np.asarray(j[key]), err_msg=key)
        if exact_shapes_only(p["labels"]):
            assert pr == jr
            kinds.add("exact")
        else:
            diff = np.abs(decode_rgb(p["jpeg"]).astype(np.int32) - decode_rgb(j["jpeg"]).astype(np.int32))
            assert diff.mean() <= MEAN_ABS_TOL, diff.mean()
            kinds.add("ellipse or ring")
    assert kinds == {"exact", "ellipse or ring"}
    if crowded:
        n_objects = [len(parse_voc_example(r)["labels"]) for r in port_records]
        assert max(n_objects) > 4  # the crowded counts' tail


@pytest.mark.parametrize("crowded", [False, True])
def test_vocdevkit_tree_is_the_jax_tools(datasets, crowded):
    """XML and test.txt byte-equal; the JPEGs as the records' images."""
    jax_voc = datasets / f"jax_{crowded}" / "VOCdevkit" / "VOC2007"
    port_voc = datasets / f"port_{crowded}" / "VOCdevkit" / "VOC2007"
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        assert sorted(os.listdir(port_voc / sub)) == sorted(os.listdir(jax_voc / sub))
    assert (port_voc / "ImageSets/Main/test.txt").read_bytes() == (jax_voc / "ImageSets/Main/test.txt").read_bytes()
    ids = (port_voc / "ImageSets/Main/test.txt").read_text().split()
    assert ids == [f"{i:06d}" for i in range(N_TEST)]
    records = list(read_records(str(datasets / f"port_{crowded}" / "records" / "synth_test_000.tfrecord")))
    difficult = 0
    for image_id, record in zip(ids, records):
        xml = (port_voc / "Annotations" / f"{image_id}.xml").read_bytes()
        assert xml == (jax_voc / "Annotations" / f"{image_id}.xml").read_bytes()
        difficult += xml.count(b"<difficult>1</difficult>")
        jpeg = (port_voc / "JPEGImages" / f"{image_id}.jpg").read_bytes()
        assert jpeg == parse_voc_example(record)["jpeg"]
    assert difficult > 0


def draw_pil(size, fn):
    im = Image.new("L", size)
    fn(ImageDraw.Draw(im))
    return np.asarray(im)


def edge_pixels(ref):
    """Pixels with an 8-neighbour of another value in `ref`."""
    h, w = ref.shape
    padded = np.pad(ref, 1, mode="edge")
    return np.any([padded[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w] != ref
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)


def object_boxes(seed, w, h, n=60):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ow, oh = rng.uniform(0.04, 0.5) * w, rng.uniform(0.04, 0.5) * h
        x0, y0 = rng.uniform(0, w - ow), rng.uniform(0, h - oh)
        yield x0, y0, x0 + ow, y0 + oh


@pytest.mark.parametrize("size", [(64, 48), (499, 321)])
def test_shapes_against_imagedraw(size):
    """Triangle and bar: Pillow's pixels exactly. Ring: the ring's and the
    hole's pixels differ only where a pixel touches one of the edges."""
    w, h = size
    rings, ring_pixels = 0, np.zeros(2, np.int64)
    for x0, y0, x1, y1 in object_boxes(w * h, w, h):
        tri = [(x0, y1), (x1, y1), ((x0 + x1) / 2, y0)]
        got = np.zeros((h, w, 3), np.uint8)
        fill_polygon(got, tri, (255, 255, 255))
        np.testing.assert_array_equal(got[..., 0], draw_pil(size, lambda d: d.polygon(tri, fill=255)))
        bh = y1 - y0
        bar = (x0, y0 + 0.35 * bh, x1, y1 - 0.35 * bh)
        got = np.zeros((h, w, 3), np.uint8)
        fill_rectangle(got, bar, (255, 255, 255))
        np.testing.assert_array_equal(got[..., 0], draw_pil(size, lambda d: d.rectangle(bar, fill=255)))

        bw = x1 - x0
        hole = (x0 + 0.3 * bw, y0 + 0.3 * bh, x1 - 0.3 * bw, y1 - 0.3 * bh)

        def ring(d):
            d.ellipse((x0, y0, x1, y1), fill=255)
            d.ellipse(hole, fill=40)

        ref = draw_pil(size, ring)
        got = np.zeros((h, w, 3), np.uint8)
        dr.draw_object(got, 5 + 5 * int(rings % 4), (x0, y0, x1, y1))  # classes 5, 10, 15, 20: rings
        color = dr.COLORS[rings % 4]
        mine = np.where((got == color).all(-1), 255, np.where((got == dr.RING_HOLE).all(-1), 40, 0))
        assert not (mine != ref)[~edge_pixels(ref)].any()
        ring_pixels += ((mine == 255).sum(), (ref == 255).sum())
        rings += 1
    assert ring_pixels[0] > 0.9 * ring_pixels[1]


def test_draw_object_covers_the_five_shapes():
    img = np.zeros((60, 60, 3), np.uint8)
    seen = set()
    for cls in range(1, 21):
        img[:] = 0
        dr.draw_object(img, cls, (10.3, 12.7, 48.9, 50.2))
        colors = {tuple(c) for c in img.reshape(-1, 3)} - {(0, 0, 0)}
        assert dr.COLORS[(cls - 1) // 5] in colors
        seen.add((dr.SHAPES[(cls - 1) % 5], len(colors)))
    assert ("ring", 2) in seen and {s for s, _ in seen} == set(dr.SHAPES)
    ref = np.zeros((60, 60, 3), np.uint8)
    fill_ellipse(ref, (10.3, 12.7, 48.9, 50.2), dr.COLORS[0])
    img[:] = 0
    dr.draw_object(img, 2, (10.3, 12.7, 48.9, 50.2))
    np.testing.assert_array_equal(img, ref)


def test_torch_vgg_checkpoint_is_the_jax_tools(tmp_path):
    got = torch.load(dr.make_torch_vgg_checkpoint(str(tmp_path / "port.pth")), weights_only=True)
    ref = torch.load(jax_tool().make_torch_vgg_checkpoint(str(tmp_path / "jax.pth")), weights_only=True)
    assert list(got) == list(ref) and len(got) == 26
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


class _Stop(Exception):
    pass


def jax_train_config(tmp_path, monkeypatch, env):
    """The TrainConfig the JAX tool's `main` hands its Trainer."""
    import ron_tensorflow_tpu.train.trainer as jax_trainer

    work = tmp_path / "jax_work"
    (work / "records").mkdir(parents=True)
    (work / "records" / "synth_train_000.tfrecord").touch()  # no dataset is drawn
    (work / "vgg16_torch_init.pth").touch()  # nor a checkpoint written
    captured = {}

    class Capture:
        def __init__(self, cfg, *args, **kwargs):
            captured["cfg"] = cfg
            raise _Stop

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jax_trainer, "Trainer", Capture)
    monkeypatch.setattr(sys, "argv", ["dress_rehearsal.py", str(work)])
    with pytest.raises(_Stop):
        jax_tool().main()
    return captured["cfg"], str(work)


def as_dict(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=str))


@pytest.mark.parametrize("env", [
    {},
    {"DR_CROWDED": "1", "DR_STEPS": "200"},
    {"DR_MODEL": "ssd_300_vgg", "DR_BATCH": "32"},
    {"DR_MODEL": "ssd_512_vgg", "DR_CROWDED": "1", "DR_STEPS": "777"},
    {"DR_MODEL": "ron_320_vgg_heavy", "DR_LR": "0.002", "DR_WARMUP": "10", "DR_CLIP": "5"},
])
def test_train_config_is_the_jax_tools(tmp_path, monkeypatch, env):
    ref, work = jax_train_config(tmp_path, monkeypatch, env)
    s = dr.settings({**os.environ, **env})
    got = dr.train_config(s["MODEL"], work, int(s["STEPS"]), int(s["BATCH"]), bool(int(s["CROWDED"])),
                          os.path.join(work, "vgg16_torch_init.pth"), {**os.environ, **env})
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(jax_config.TrainConfig)]
    assert as_dict(got) == as_dict(ref)
    assert got.fuse_block1 is False and got.bfloat16 is True  # K-B stays off, as in the JAX tool


def jax_result_keys():
    """The keys of the `result` dict in the JAX tool's `main`."""
    tree = ast.parse(JAX_TOOL.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result":
            return tuple(k.value for k in node.value.keys)
    raise AssertionError("no result dict in the JAX tool")


@pytest.fixture(scope="module")
def tiny_weights():
    """A tiny RON with seeded weights on both sides (f32): the JAX model and
    its variables, and the port's model: `seeded_flax_params`' draws, the
    box heads scaled down (the boxes stay near their anchors and some meet
    a gt) and the class and objectness heads' kernels up (sharper scores,
    so that the realtime head's 0.6 select threshold passes some)."""
    model = RON(RON_TINY_SPEC)
    params, stats = seeded_flax_params(model, 11)
    scale = {"_box/pred/conv/": 0.01, "_cls/pred/conv/kernel": 4.0, "objectness/score/conv/kernel": 4.0}
    params = {k: v * np.float32(next((g for part, g in scale.items() if part in k), 1.0)) for k, v in params.items()}
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    jvars = {"params": jax.tree.map(jnp.asarray, unflatten_params(params)),
             "batch_stats": jax.tree.map(jnp.asarray, unflatten_params(stats))}
    return JaxRON(spec=JAX_TINY_SPEC), jvars, model


@pytest.fixture(scope="module")
def tiny_rehearsal(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_rehearsal")
    dr.make_dataset(str(root), 0, TINY_TEST, seed=3, crowded=True)
    return root


def jax_streaming_map(jmodel, jvars, rec_dir):
    """The JAX tool's streaming evaluation (`tools/dress_rehearsal.py:358-387`)."""
    jcfg = JaxDetectionConfig(select_threshold=0.01, objectness_threshold=0.03, top_k=200, keep_top_k=100,
                              shared_top_k=1000)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(dr.STREAMING)
    pcfg = JaxPipelineConfig(batch_size=8, working_shape=JAX_TINY_SPEC.img_shape, max_boxes=dr.max_boxes(True),
                             shuffle=False, keep_difficult=True, eval_resize="WARP_RESIZE")

    def eval_batches():
        for hb in JaxPrefetchIterator(jax_batch_iterator(dr.eval_record_files(rec_dir), pcfg, epochs=1,
                                                         drop_remainder=False)):
            image = hb["image01"]
            yield {"image": jax_whiten_np(image.astype(np.float32) / 255.0 if image.dtype == np.uint8 else image),
                   "gt_labels": hb["gt_labels"], "gt_boxes": hb["gt_boxes"], "gt_difficult": hb["gt_difficult"],
                   "sample_valid": hb["sample_valid"]}

    with jax.default_matmul_precision("highest"):
        return JaxStreamingEvaluator(jmodel, JAX_TINY_SPEC, jcfg).run(jvars, eval_batches(), log_every=0)


def detections(output_dir):
    with open(output_dir / "detections.pkl", "rb") as f:
        return pickle.load(f)


def test_evaluators_give_jax_map(tiny_rehearsal, tiny_weights):
    """The rehearsal's two evaluations (its configs, pipelines and VOC
    protocol) with the same tiny RON on both sides (f32): JAX's mAP07 within
    1e-6. The streaming mAP is above 0 (seeded weights find a few of the
    TINY_TEST crowded images' gts). The realtime head keeps boxes, none a hit, at the
    published objectness gate 0.95 and at 0.5 (DR_OBJ_THRESH): its
    detections (pixels, scores) equal JAX's within 1e-3 px and 1e-5."""
    jmodel, jvars, model = tiny_weights
    rec_dir, voc_root = str(tiny_rehearsal / "records"), str(tiny_rehearsal / "VOCdevkit")
    got07, got12, _, _ = dr.streaming_eval(model, RON_TINY_SPEC, rec_dir, True, "cpu")
    ref07, ref12, _, _ = jax_streaming_map(jmodel, jvars, rec_dir)
    assert got07 == pytest.approx(ref07, abs=MAP_TOL) and got12 == pytest.approx(ref12, abs=MAP_TOL)
    assert got07 > 0
    kept = 0
    for obj_thresh in (float(dr.DEFAULTS["OBJ_THRESH"]), 0.5):
        port_out, jax_out = tiny_rehearsal / f"rt_port_{obj_thresh}", tiny_rehearsal / f"rt_jax_{obj_thresh}"
        got_rt, got_aps = dr.realtime_eval(model, RON_TINY_SPEC, voc_root, obj_thresh, str(port_out), "cpu")
        with jax.default_matmul_precision("highest"):
            ref_rt, ref_aps = JaxRealtimeEvaluator(
                jmodel, JAX_TINY_SPEC, JaxRealtimeConfig.for_spec(JAX_TINY_SPEC, objectness_threshold=obj_thresh)
            ).evaluate_voc(jvars, voc_root, "test", output_dir=str(jax_out))
        assert got_rt == pytest.approx(ref_rt, abs=MAP_TOL)
        assert got_aps == pytest.approx(ref_aps, abs=MAP_TOL)
        for got_cls, ref_cls in zip(detections(port_out), detections(jax_out)):
            for g, r in zip(got_cls, ref_cls):
                assert g.shape == r.shape
                np.testing.assert_allclose(g[:, :4], r[:, :4], rtol=0, atol=1e-3)
                np.testing.assert_allclose(g[:, 4], r[:, 4], rtol=0, atol=1e-5)
                kept += len(g)
    assert kept > 0


def save_tiny_checkpoint(work, model):
    sd = model.state_dict()
    params = {k: v for k, v in sd.items() if "running_" not in k and "num_batches" not in k}
    stats = {k: v for k, v in sd.items() if k not in params}
    CheckpointManager(str(work / "model")).save(7, {"params": params, "batch_stats": stats})


def test_ab_prints_nine_variants(tiny_rehearsal, tiny_weights, tmp_path, monkeypatch, capsys):
    """The A/B over a tiny RON checkpoint: nine lines, the verdict, the
    K-A/K-C parting count and one JSON line; on the CPU the exact run, the
    approx-top-k run and the fixpoint run all take K-C's plain version and
    agree exactly, and so do 'auto' and the exact run ('auto' is K-C's plain
    version on the CPU)."""
    work = tmp_path / "ab"
    shutil.copytree(tiny_rehearsal / "records", work / "records")
    save_tiny_checkpoint(work, tiny_weights[2])
    monkeypatch.setenv("AB_MAX_BOXES", "56")
    out = ab.main(["--device", "cpu", str(work), "ron_tiny_vgg"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[ab] ron_tiny_vgg @ step 7"
    assert [line.split(":")[0].strip() for line in lines[1:10]] == list(ab.VARIANTS)
    assert lines[10].startswith(("all speed knobs lossless", "LOSSLESS-KNOB MISMATCH"))
    assert lines[11].startswith("K-A vs K-C keep sets")
    assert json.loads(lines[-1]) == out
    m = out["map07"]
    assert list(m) == list(ab.VARIANTS) and all(np.isfinite(v) for v in m.values())
    exact = m[ab.EXACT]
    assert exact > 0
    assert m["approx_top_k only"] == m["fixpoint NMS"] == exact
    assert m["nms thresh=0.45 (semantic)"] != exact or m["nms thresh=0.30 (semantic)"] != exact
    parting = out["keep_set_parting"]
    assert parting["rows"] == TINY_TEST * (RON_TINY_SPEC.num_classes - 1) and parting["rows_parted"] <= parting["rows"]


def test_main_end_to_end_writes_the_jax_keys(tmp_path, monkeypatch, capsys):
    """`main` at DR_TRAIN=8 DR_TEST=4 DR_STEPS=2 DR_BATCH=2 on the tiny RON:
    draws, trains from the seeded VGG, restores, scores with both
    evaluators, writes result.json with the JAX tool's keys and its
    rehearsal.json entry, and fails the mAP gate (exit 1); a second run
    with DR_SKIP_TRAIN=1 replaces that entry."""
    for k, v in {"DR_MODEL": "ron_tiny_vgg", "DR_TRAIN": "8", "DR_TEST": "4", "DR_STEPS": "2",
                 "DR_BATCH": "2"}.items():
        monkeypatch.setenv(k, v)
    work = tmp_path / "work"
    try:
        assert dr.main(["--device", "cpu", str(work)]) == 1
        result = json.loads((work / "result.json").read_text())
        assert tuple(result) == dr.RESULT_KEYS == jax_result_keys()
        assert result["model"] == "ron_tiny_vgg" and result["steps"] == 2 and result["crowded"] is False
        assert all(np.isfinite(result[k]) for k in dr.RESULT_KEYS[3:])
        assert "DRESS REHEARSAL: FAIL" in capsys.readouterr().out
        monkeypatch.setenv("DR_SKIP_TRAIN", "1")
        assert dr.main(["--device", "cpu", str(work)]) == 1
        runs = json.loads((work / "rehearsal.json").read_text())
        assert len(runs) == 1 and runs[0] == {**json.loads((work / "result.json").read_text()), "ok": False}
        assert runs[0]["steps"] == 2
        assert len(list((work / "records").glob("synth_train_*.tfrecord"))) == 1
    finally:
        shutil.rmtree(work / "model", ignore_errors=True)  # ~0.7 GB with the momentum trace


def test_main_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        dr.main([str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        ab.main([str(tmp_path)])
