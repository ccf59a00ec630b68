"""The port's configs (`config.py`: `EvalConfig`, `load_config`,
`_from_dict`) and presets (`presets.py`) against the JAX package's: every
field and default, JSON files with dotted overrides, every preset. A
nonzero `shared_top_k` loads as JAX's does; an eval mesh loads, and its
batch size must divide over the data axis."""

import dataclasses
import json

import pytest

from ron_tensorflow_tpu import config as jax_config
from ron_tensorflow_tpu import presets as jax_presets

from ron_tensorflow_tpu_torch import config, presets


def as_dict(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=str))


def test_eval_config_defaults_match_jax_field_by_field():
    got, want = config.EvalConfig(), jax_config.EvalConfig()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert as_dict(got)[f.name] == as_dict(want)[f.name], f.name


@pytest.mark.parametrize("cls", ["TrainConfig", "EvalConfig"])
def test_json_file_and_overrides_match_jax(tmp_path, cls):
    data = {"model": "ssd_300_vgg", "model_dir": "/m", "data": {"batch_size": 5, "working_shape": [300, 300],
                                                                "dataset_dir": "/records"},
            "match": {"positive_threshold": 0.45}}
    if cls == "EvalConfig":
        data.update(select_top_k=400, resize="CENTRAL_CROP", max_evals=3, debug_dir=None)
    else:
        data.update(checkpoint_exclude_scopes=["reverse", "block4"], mesh_shape=[1, 1], ema_decay=0.999)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(data))
    overrides = ["data.batch_size=7", "data.shuffle=false", "seed=3" if cls == "TrainConfig" else "max_batches=2",
                 "optimizer.learning_rate=0.01" if cls == "TrainConfig" else "use_ema=true"]
    got = config.load_config(getattr(config, cls), str(path), overrides)
    want = jax_config.load_config(getattr(jax_config, cls), str(path), overrides)
    assert as_dict(got) == as_dict(want)
    assert got.data.working_shape == (300, 300) and got.data.batch_size == 7
    # no file: the base (a preset) takes the overrides
    base = presets.get_preset("eval" if cls == "EvalConfig" else "train", "ssd_512")
    jbase = jax_presets.get_preset("eval" if cls == "EvalConfig" else "train", "ssd_512")
    assert as_dict(config.load_config(getattr(config, cls), None, overrides, base=base)) == \
        as_dict(jax_config.load_config(getattr(jax_config, cls), None, overrides, base=jbase))


def test_unknown_override_and_bad_form_raise():
    with pytest.raises(KeyError, match="no_such_field"):
        config.load_config(config.EvalConfig, None, ["no_such_field=1"])
    with pytest.raises(KeyError, match="nope"):
        config.load_config(config.TrainConfig, None, ["data.nope=1"])
    with pytest.raises(ValueError, match="not key=value"):
        config.load_config(config.EvalConfig, None, ["bfloat16"])


@pytest.mark.parametrize("kind", ["eval", "train"])
def test_every_preset_matches_jax(kind):
    table, jtable = ((presets.EVAL_PRESETS, jax_presets.EVAL_PRESETS) if kind == "eval"
                     else (presets.TRAIN_PRESETS, jax_presets.TRAIN_PRESETS))
    assert sorted(table) == sorted(jtable) == ["ron_320", "ssd_300", "ssd_512"]
    for name in jtable:
        got = presets.get_preset(kind, name)
        assert as_dict(got) == as_dict(jax_presets.get_preset(kind, name)), name
        assert got is not table[name]  # a copy
    with pytest.raises(KeyError, match="unknown eval preset"):
        presets.get_preset("eval", "yolo")


def test_tpu_only_and_distributed_eval_options_raise():
    assert config.EvalConfig(shared_top_k=0).shared_top_k == 0  # JAX's default, in its config files
    got = config.load_config(config.EvalConfig, None, ["shared_top_k=1000"])
    assert got.shared_top_k == 1000
    assert as_dict(got) == as_dict(jax_config.load_config(jax_config.EvalConfig, None, ["shared_top_k=1000"]))
    assert config.EvalConfig(mesh_shape=(1, 1)).mesh_shape == (1, 1)
    assert tuple(config.load_config(config.EvalConfig, None, ["mesh_shape=[2, 1]"]).mesh_shape) == (2, 1)
    with pytest.raises(ValueError, match="does not divide over the data axis"):
        config.load_config(config.EvalConfig, None, ["mesh_shape=[3, 1]"])  # the default batch of 8
