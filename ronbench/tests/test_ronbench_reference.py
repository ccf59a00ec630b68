"""The plain reference against the port in float32 on the CPU, on the
benchmark's own weights: the forwards, the anchors and both heads'
postprocess. The port is imported here only, never by the reference."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ronbench import scenes
from ronbench import weights as W
from ronbench.reference import nets, postprocess

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
TINY = json.loads((HERE / "data" / "ron_tiny.json").read_text())
TRAFFIC = json.loads((ROOT / "ronbench" / "traffic" / "detect_b64_crowded.json").read_text())


def port_model(cfg, weights):
    from ron_tensorflow_tpu_torch.models import get_network

    model, spec = get_network(cfg["network"], dtype=torch.float32)
    model.load_state_dict(weights, strict=True)
    return model.eval(), spec


def images(cfg, n, seed=3):
    pixels, _ = scenes.draw_pool(seed, n, *cfg["img_shape"], TRAFFIC["scenes"])
    return torch.from_numpy(scenes.whiten(pixels))


def config(name):
    return json.loads((ROOT / "ronbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, batch", [("tiny", 2), ("ssd300", 1)])
def test_forward_matches_the_port_in_float32(name, batch):
    cfg = TINY if name == "tiny" else config(name)
    w = W.load(cfg, 11, "cpu")
    model, spec = port_model(cfg, w)
    x = images(cfg, batch)
    with torch.no_grad():
        out, ref = model(x), nets.heads(cfg, w, x)
    for key in ("logits", "objness_logits", "locations", "predictions", "objness_pred"):
        got = getattr(out, key)
        scale = float(ref[key].abs().max())
        assert float((got - ref[key]).abs().max()) <= 1e-5 * max(scale, 1.0), key
    assert np.array_equal(postprocess.anchors(cfg), spec.anchor_layout().cyxhw)


def test_fixture_weights_give_the_port_s_forward():
    cfg = config("ron320")
    w = W.load(cfg, 0, "cpu")
    model, _ = port_model(cfg, w)
    x = images(cfg, 1)
    with torch.no_grad():
        out, ref = model(x), nets.heads(cfg, w, x)
    assert float((out.logits - ref["logits"]).abs().max()) <= 1e-5 * float(ref["logits"].abs().max())


def test_detect_head_matches_the_port_s_detector_on_the_same_heads():
    from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig, Detector

    w = W.load(TINY, 5, "cpu")
    model, spec = port_model(TINY, w)
    det = Detector(model, spec, DetectionConfig(**TINY["detection"], nms_method="pallas"), device="cpu")
    x = images(TINY, 2)
    with torch.no_grad():
        out = model(x)
        scores, boxes = det.postprocess(out)
    mine = postprocess.detect(out._asdict(), TINY)
    assert torch.equal(scores, mine["scores"])
    assert float((boxes - mine["boxes"]).abs().max()) <= 1e-6


def test_realtime_head_matches_the_port_s_head_on_the_same_heads():
    from ron_tensorflow_tpu_torch.inference.detector import RealtimeConfig, RealtimeDetector

    w = W.load(TINY, 6, "cpu")
    model, spec = port_model(TINY, w)
    rt = RealtimeDetector(model, spec, RealtimeConfig(**TINY["realtime"]), device="cpu")
    x = images(TINY, 2)
    with torch.no_grad():
        out = model(x)
        scores, labels, boxes, valid = rt.postprocess(out)
    mine = postprocess.realtime(out._asdict(), TINY)
    assert int(valid.sum()) > 0
    assert torch.equal(valid, mine["valid"]) and torch.equal(scores, mine["scores"])
    assert torch.equal(labels.long(), mine["labels"].long())
    assert float((boxes - mine["boxes"]).abs().max()) <= 1e-6


def test_seeded_weights_follow_the_seed_and_flax_s_initializers():
    cfg = config("ssd300")
    a, b, c = W.seeded(cfg, 3, "cpu"), W.seeded(cfg, 3, "cpu"), W.seeded(cfg, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1_1.conv.weight"], c["conv1_1.conv.weight"])
    limit = (6.0 / (9 * 3 + 9 * 64)) ** 0.5
    assert float(a["conv1_1.conv.weight"].abs().max()) <= limit
    assert float(a["conv1_1.conv.bias"].abs().max()) == 0.0
    assert torch.equal(a["block4_box.l2_norm.gamma"], torch.full((512,), 20.0))


def test_train_encoding_matches_the_port_s_encoder():
    """Labels and offsets equal to the port's TargetEncoder on crowded gts,
    among them IoUs within a rounding of a match threshold (this seed's
    scenes held two such anchors when the union was rounded twice)."""
    from ron_tensorflow_tpu_torch.models import get_spec
    from ron_tensorflow_tpu_torch.ops.encode import TargetEncoder

    from ronbench.entries.train import gts
    from ronbench.reference import train as ref_train

    cfg, spec = config("ron320"), get_spec("ron_320_vgg")
    encoder = TargetEncoder(spec.anchor_layout(), spec.img_shape, cfg["match"]["positive_threshold"],
                            cfg["match"]["ignore_threshold"], spec.prior_scaling)
    rng = np.random.default_rng(2147490001)
    objects = [scenes.draw_scene(rng, 64, 64, TRAFFIC["scenes"])[1] for _ in range(128)]
    labels, boxes, valid = (torch.from_numpy(a) for a in gts(objects, 56))
    port = encoder.batched(labels, boxes, valid)
    ref_labels, ref_offsets = ref_train.encode(cfg, labels, boxes, valid)
    assert torch.equal(port.labels.long(), ref_labels)
    assert torch.equal(port.locations, ref_offsets)
