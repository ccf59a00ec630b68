"""Named config presets reproducing the reference scripts' defaults.

A copy of `ron_tensorflow_tpu/presets.py`. The reference hardcoded per-script
flag defaults (eval_ron_network.py:64-90 for RON, eval_ssd_network.py:45-60
for SSD, ron_net.py:52-180 for training). Here each recipe is a named preset
applied before any `key=value` overrides:

  python -m ron_tensorflow_tpu_torch.cli eval --preset ssd_300 --model-dir ... \
      --dataset-dir ...
"""

from __future__ import annotations

import dataclasses

from .config import DataConfig, EvalConfig, MatchConfig, TrainConfig


def _ssd_eval(model: str) -> EvalConfig:
    # ref: eval_ssd_network.py:45-60: select 0.01 / top-k 400 / keep 200 /
    # NMS 0.45 / matching 0.5 / WARP_RESIZE; batch 1 in the reference, 8 here.
    # SSD has no objectness prior, so the gate threshold is 0.
    return EvalConfig(
        model=model,
        data=DataConfig(
            dataset_name="pascalvoc_2007",
            split_name="test",
            file_pattern="voc_2007_test_*.tfrecord",
            batch_size=8,
            shuffle=False,
            keep_difficult=True,
        ),
        match=MatchConfig(positive_threshold=0.5),
        select_threshold=0.01,
        objectness_threshold=0.0,
        select_top_k=400,
        keep_top_k=200,
        nms_threshold=0.45,
        matching_threshold=0.5,
        resize="WARP_RESIZE",
    )


EVAL_PRESETS = {
    # ref: eval_ron_network.py:64-90 (the EvalConfig defaults ARE this recipe)
    "ron_320": EvalConfig(),
    "ssd_300": _ssd_eval("ssd_300_vgg"),
    "ssd_512": _ssd_eval("ssd_512_vgg"),
}

TRAIN_PRESETS = {
    # ref: ron_net.py:52-180 + README.md:34 recipe (the TrainConfig defaults)
    "ron_320": TrainConfig(),
    # the ssd_300/512 paper hyper-parameters through the trainer (the
    # reference ships no SSD trainer); the hard-negative loss is dispatched
    # for ssd* models
    "ssd_300": TrainConfig(
        model="ssd_300_vgg",
        match=MatchConfig(positive_threshold=0.5, ignore_threshold=0.5),
    ),
    "ssd_512": TrainConfig(
        model="ssd_512_vgg",
        match=MatchConfig(positive_threshold=0.5, ignore_threshold=0.5),
    ),
}


def get_preset(kind: str, name: str):
    table = EVAL_PRESETS if kind == "eval" else TRAIN_PRESETS
    if name not in table:
        raise KeyError(f"unknown {kind} preset {name!r}; options: {sorted(table)}")
    return dataclasses.replace(table[name])
