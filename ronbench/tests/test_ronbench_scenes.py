"""The traffic generator: scenes follow the seed, and only the seed."""

import json
from pathlib import Path

import numpy as np

from ronbench import scenes

TRAFFIC = json.loads((Path(__file__).resolve().parents[1] / "traffic" / "detect_b64_crowded.json").read_text())


def test_same_seed_same_scenes():
    a, objs_a = scenes.draw_pool(2**31 + 17, 6, 64, 80, TRAFFIC["scenes"])
    b, objs_b = scenes.draw_pool(2**31 + 17, 6, 64, 80, TRAFFIC["scenes"])
    assert np.array_equal(a, b) and objs_a == objs_b


def test_other_seed_other_scenes_same_sizes():
    a, _ = scenes.draw_pool(1, 6, 64, 80, TRAFFIC["scenes"])
    b, _ = scenes.draw_pool(2, 6, 64, 80, TRAFFIC["scenes"])
    assert a.shape == b.shape == (6, 64, 80, 3) and a.dtype == b.dtype == np.uint8
    assert not np.array_equal(a, b)


def test_object_counts_follow_the_bands():
    rng = np.random.default_rng(0)
    counts = np.array([scenes.n_objects(rng, TRAFFIC["scenes"]["objects"]) for _ in range(4000)])
    assert counts.min() >= 1 and counts.max() <= 48
    assert abs((counts <= 5).mean() - 0.55) < 0.03 and abs((counts >= 19).mean() - 0.10) < 0.02
    expected = sum(share * (low + high) / 2 for share, low, high in TRAFFIC["scenes"]["objects"])  # 9.2
    assert abs(counts.mean() - expected) < 0.4


def test_scene_boxes_lie_in_the_image_and_shapes_are_drawn():
    img, objs = scenes.draw_scene(np.random.default_rng(5), 320, 320, TRAFFIC["scenes"])
    assert objs and all(0.0 <= y0 < y1 <= 1.0 and 0.0 <= x0 < x1 <= 1.0 for _, (y0, x0, y1, x1) in objs)
    assert all(1 <= label <= 20 for label, _ in objs)
    assert (img.max(axis=-1) >= 200).any()  # some object colour on the dark background


def test_whiten_subtracts_the_vgg_means():
    px = np.full((1, 2, 2, 3), 200, np.uint8)
    assert np.allclose(scenes.whiten(px)[0, 0, 0], [77.0, 83.0, 96.0])
