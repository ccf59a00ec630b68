"""The port's warm start against the JAX package's: `warm_start_params` and
`torch_vgg_to_flat` on the same inputs, and the Trainer's warm start from
torch, TF and Caffe sources against the JAX Trainer's `init_state` on the
same initial weights, tensor for tensor and bit for bit.

The JAX trainer's `create_train_state` is replaced by one that hands it the
port's seeded init (flax's own init of these 94 M parameters takes ~18 s
here); everything after it (auto-resume, `_warm_start`, the importers,
`state.replace(params=...)`) is the JAX package's own code.
"""

import dataclasses
import shutil
from unittest import mock

import numpy as np
import pytest
import torch

from ron_tensorflow_tpu import config as jax_config
from ron_tensorflow_tpu.train import checkpoint as jax_ckpt
from ron_tensorflow_tpu.train import trainer as jax_trainer
from ron_tensorflow_tpu.train.state import TrainState as JaxTrainState

from ron_tensorflow_tpu_torch.config import TrainConfig, apply_overrides
from ron_tensorflow_tpu_torch.data.example import _len_delimited, _varint
from ron_tensorflow_tpu_torch.train.checkpoint import (
    flatten_params,
    torch_vgg_to_flat,
    unflatten_params,
    warm_start_params,
)
from ron_tensorflow_tpu_torch.train.trainer import Trainer
from ron_tensorflow_tpu_torch.weights import to_jax_params

# VGG-16 convs (reduced fc6/fc7) as (torch index, name, in, out, k)
VGG = [(i, n, ci, co, 3) for i, n, ci, co in (
    (0, "conv1_1", 3, 64), (2, "conv1_2", 64, 64), (5, "conv2_1", 64, 128), (7, "conv2_2", 128, 128),
    (10, "conv3_1", 128, 256), (12, "conv3_2", 256, 256), (14, "conv3_3", 256, 256), (17, "conv4_1", 256, 512),
    (19, "conv4_2", 512, 512), (21, "conv4_3", 512, 512), (24, "conv5_1", 512, 512), (26, "conv5_2", 512, 512),
    (28, "conv5_3", 512, 512), (31, "fc6", 512, 1024))] + [(33, "fc7", 1024, 1024, 1)]


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


def seeded_vgg(seed=0, prefix="vgg."):
    """A VGG-16 state dict (OIHW) with fan-in scaled draws."""
    rng = np.random.default_rng(seed)
    sd = {}
    for idx, _, cin, cout, k in VGG:
        sd[f"{prefix}{idx}.weight"] = torch.from_numpy(
            (rng.standard_normal((cout, cin, k, k)) * np.sqrt(2.0 / (cin * k * k))).astype(np.float32))
        sd[f"{prefix}{idx}.bias"] = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
    return sd


# --------------------------------------------------------------------------- #
# The functions


def flat_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"backbone/conv1_1/conv/kernel": (3, 3, 3, 4), "backbone/conv1_1/conv/bias": (4,),
              "backbone/fc7/conv/kernel": (1, 1, 4, 4), "block4_reverse/conv_left/conv/kernel": (3, 3, 4, 4),
              "block5_reverse/deconv_right/deconv_kernel": (2, 2, 4, 4), "block4_objectness/conv/bn/scale": (4,),
              "block4_cls/pred/conv/bias": (8,)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


WARM_CASES = {
    "prefix": dict(exclude_scopes=("block4",)),
    "regex": dict(exclude_scopes=("reverse",)),  # no key starts with it: excluded by re.search
    "regex_anchored": dict(exclude_scopes=(r"^block\d_(cls|objectness)",)),
    "rename": dict(rename_map={"backbone": "vgg_16"}),
    "rename_and_exclude": dict(rename_map={"backbone": "vgg_16", "block": "other"}, exclude_scopes=("fc7",)),
    "nothing": dict(exclude_scopes=(".",)),
}


@pytest.mark.parametrize("case", list(WARM_CASES))
def test_warm_start_params_equals_jax(case):
    kw = WARM_CASES[case]
    params = unflatten_params(flat_tree(0))
    source = {k: v.astype(np.float64) for k, v in flat_tree(1).items()}  # cast to the target's float32
    if "rename_map" in kw:
        for tgt, src in kw["rename_map"].items():
            source.update({src + k[len(tgt):]: v for k, v in source.items() if k.startswith(tgt)})
    del source["block4_cls/pred/conv/bias"]
    ours = flatten_params(warm_start_params(params, source, verbose=False, **kw))
    theirs = jax_ckpt.flatten_params(jax_ckpt.warm_start_params(jax_ckpt.unflatten_params(flat_tree(0)), source,
                                                                verbose=False, **kw))
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == np.float32 and np.array_equal(ours[k], theirs[k]), k
    if case == "regex":
        assert np.array_equal(ours["block5_reverse/deconv_right/deconv_kernel"],
                              flat_tree(0)["block5_reverse/deconv_right/deconv_kernel"])
        assert np.array_equal(ours["block4_objectness/conv/bn/scale"],
                              source["block4_objectness/conv/bn/scale"].astype(np.float32))


def test_warm_start_params_raises_as_jax_does():
    params = unflatten_params(flat_tree(0))
    bad = dict(flat_tree(1))
    bad["backbone/conv1_1/conv/kernel"] = np.zeros((3, 3, 4, 4), np.float32)
    for fn, tree in ((warm_start_params, params), (jax_ckpt.warm_start_params, jax_ckpt.unflatten_params(flat_tree(0)))):
        with pytest.raises(ValueError, match="shape mismatch for backbone/conv1_1/conv/kernel"):
            fn(tree, bad, verbose=False)
        partial = {k: v for k, v in flat_tree(1).items() if "cls" not in k}
        with pytest.raises(KeyError, match="block4_cls/pred/conv/bias"):
            fn(tree, partial, ignore_missing=False, verbose=False)
        fn(tree, partial, ignore_missing=False, exclude_scopes=("block4_cls",), verbose=False)


@pytest.mark.parametrize("layout", ["vgg.", "features."])
@pytest.mark.parametrize("backbone_prefix", ["backbone", ""])
@pytest.mark.parametrize("bgr_to_rgb", [False, True])
def test_torch_vgg_to_flat_equals_jax(layout, backbone_prefix, bgr_to_rgb):
    sd = seeded_vgg(3, layout)
    if layout == "features.":  # torchvision's VGG-16 has no reduced fc6/fc7 among its features
        sd = {k: v for k, v in sd.items() if int(k.split(".")[1]) < 30}
    ours = torch_vgg_to_flat(sd, backbone_prefix=backbone_prefix, bgr_to_rgb=bgr_to_rgb)
    theirs = jax_ckpt.torch_vgg_to_flat(sd, backbone_prefix=backbone_prefix, bgr_to_rgb=bgr_to_rgb)
    assert list(ours) == list(theirs) and len(ours) == (30 if layout == "vgg." else 26)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k
    pfx = f"{backbone_prefix}/" if backbone_prefix else ""
    w = sd[f"{layout}0.weight"].numpy().transpose(2, 3, 1, 0)
    assert np.array_equal(ours[f"{pfx}conv1_1/conv/kernel"], w[:, :, ::-1] if bgr_to_rgb else w)


# --------------------------------------------------------------------------- #
# The Trainer


def port_config(tmp_path, **kw):
    cfg = apply_overrides(TrainConfig(), ["model=ron_tiny_vgg", "bfloat16=false", "optimizer.optimizer=sgd",
                                          "tensorboard=false", "data.batch_size=1"])
    return dataclasses.replace(cfg, **{"model_dir": str(tmp_path / "model"), "ema_decay": 0.9, **kw})


def flat_of(model, tensors):
    return to_jax_params(model, tensors.items())


@pytest.fixture(scope="module")
def seeded_init(tmp_path_factory):
    """{model: (params, batch stats)} of a Trainer's seeded init, flax names."""
    out = {}
    for model in ("ron_tiny_vgg", "ssd_300_vgg"):
        t = Trainer(port_config(tmp_path_factory.mktemp("init"), model=model), device="cpu")
        st = t.init_state()
        out[model] = (flat_of(t.model, st.params), flat_of(t.model, st.batch_stats))
    return out


def write_caffemodel(path, sd):
    """A Caffe model of `sd`'s VGG (caffe's layer names), with conv4_3's
    L2-normalization scale, as SSD's Caffe VGG carries it."""
    def blob(a):
        return _len_delimited(7, _len_delimited(1, b"".join(_varint(d) for d in a.shape))) + \
            _len_delimited(5, a.astype("<f4").tobytes())

    net = b""
    for idx, name, *_ in VGG:
        w, b = sd[f"vgg.{idx}.weight"].numpy(), sd[f"vgg.{idx}.bias"].numpy()
        net += _len_delimited(100, _len_delimited(1, name.encode()) + _len_delimited(2, b"Convolution")
                              + _len_delimited(7, blob(w)) + _len_delimited(7, blob(b)))
    gamma = np.full((512,), 20.5, np.float32)
    net += _len_delimited(100, _len_delimited(1, b"conv4_3_norm") + _len_delimited(2, b"Normalize")
                          + _len_delimited(7, blob(gamma)))
    path.write_bytes(net)


def write_source(fmt, tmp_path, sd):
    if fmt == "torch":
        path = tmp_path / "vgg16_reducedfc.pth"
        torch.save(sd, path)
        return str(path)
    if fmt == "caffe":
        path = tmp_path / "vgg16.caffemodel"
        write_caffemodel(path, sd)
        return str(path)
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    graph = tf1.Graph()
    with graph.as_default():
        for idx, name, *_ in VGG:
            scope = f"vgg_16/{name}" if name.startswith("fc") else f"vgg_16/{name[:5]}/{name}"
            tf1.Variable(sd[f"vgg.{idx}.weight"].numpy().transpose(2, 3, 1, 0), name=f"{scope}/weights")
            tf1.Variable(sd[f"vgg.{idx}.bias"].numpy(), name=f"{scope}/biases")
        tf1.train.get_or_create_global_step()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            return tf1.train.Saver().save(sess, str(tmp_path / "vgg_16.ckpt"), write_meta_graph=False)


def jax_init_state(params, stats):
    """Stands in for the JAX trainer's `create_train_state`: the given
    init, the EMA a copy of it, taken before any warm start."""
    def create(*args, ema=False, **kwargs):
        return JaxTrainState(step=np.zeros((), np.int32), params=jax_ckpt.unflatten_params(dict(params)),
                             batch_stats=jax_ckpt.unflatten_params(dict(stats)), opt_state=None,
                             ema_params=jax_ckpt.unflatten_params({k: v.copy() for k, v in params.items()})
                             if ema else None)
    return create


@pytest.mark.parametrize("fmt,model", [("torch", "ron_tiny_vgg"), ("tf", "ron_tiny_vgg"), ("caffe", "ron_tiny_vgg"),
                                       ("caffe", "ssd_300_vgg")])
def test_trainer_warm_start_equals_jax(fmt, model, tmp_path, seeded_init, capsys):
    sd = seeded_vgg(7)
    path = write_source(fmt, tmp_path, sd)
    kw = dict(model=model, checkpoint_path=path, checkpoint_format=fmt, checkpoint_bgr_to_rgb=fmt != "tf")
    t = Trainer(port_config(tmp_path, **kw), device="cpu")
    st = t.init_state()
    ours, ours_stats, ours_ema = (flat_of(t.model, d) for d in (st.params, st.batch_stats, st.ema_params))
    init, init_stats = seeded_init[model]

    jcfg = jax_config.TrainConfig(model_dir=str(tmp_path / "jax"), bfloat16=False, ema_decay=0.9, **kw)
    jtr = jax_trainer.Trainer(jcfg)
    with mock.patch.object(jax_trainer, "create_train_state", jax_init_state(init, init_stats)):
        jst = jtr.init_state()
    theirs = jax_ckpt.flatten_params(jst.params)
    assert sorted(theirs) == sorted(ours)
    for k in ours:  # what JAX restores, the port restores; what JAX leaves at init, so does the port
        assert theirs[k].dtype == ours[k].dtype and np.array_equal(theirs[k], ours[k]), k
    restored = {k for k in ours if not np.array_equal(ours[k], init[k])}
    n_convs = 30 if model.startswith("ron") else 26  # SSD's fc6/fc7 are conv6/conv7: caffe's names miss them
    assert len(restored) == n_convs and all(k.split("/")[0] in ("backbone", *(n for _, n, *_ in VGG))
                                            for k in restored)
    assert f"[warm-start] restored {n_convs} tensors" in capsys.readouterr().out
    # BatchNorm statistics and the EMA stay at the seeded init, in JAX too
    theirs_ema = jax_ckpt.flatten_params(jst.ema_params)
    for k in ours:
        assert np.array_equal(ours_ema[k], init[k]) and np.array_equal(theirs_ema[k], init[k]), k
    for k in ours_stats:
        assert np.array_equal(ours_stats[k], init_stats[k]), k
    # the model's own tensors were written, in place
    assert all(st.params[n] is p for n, p in t.model.named_parameters())


def test_auto_resume_takes_precedence_over_warm_start(tmp_path, capsys):
    path = write_source("torch", tmp_path, seeded_vgg(7))
    t = Trainer(port_config(tmp_path, ema_decay=None), device="cpu")
    st = t.init_state()
    with torch.no_grad():
        for p in st.params.values():
            p.add_(0.5)
    st.step = 3
    t._ckpt.save(3, st)
    saved = {k: v.clone() for k, v in st.params.items()}
    capsys.readouterr()
    t2 = Trainer(port_config(tmp_path, ema_decay=None, checkpoint_path=path), device="cpu")
    st2 = t2.init_state()
    out = capsys.readouterr().out
    assert st2.step == 3 and "resumed from step 3" in out and "[warm-start]" not in out
    assert all(torch.equal(st2.params[k], saved[k]) for k in saved)


def test_orbax_format_reads_the_converter_npz_and_names_it_for_a_directory(tmp_path, seeded_init, capsys):
    init, _ = seeded_init["ron_tiny_vgg"]
    rng = np.random.default_rng(5)
    source = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in init.items() if "cls" not in k}
    np.savez(tmp_path / "state.npz", step=np.int64(7), **{f"params/{k}": v for k, v in source.items()})
    cfg = port_config(tmp_path, checkpoint_path=str(tmp_path / "state.npz"), checkpoint_format="orbax")
    t = Trainer(cfg, device="cpu")
    ours = flat_of(t.model, t.init_state().params)
    want = jax_ckpt.flatten_params(jax_ckpt.warm_start_params(jax_ckpt.unflatten_params(dict(init)), source,
                                                              exclude_scopes=cfg.checkpoint_exclude_scopes,
                                                              verbose=False))
    assert all(np.array_equal(ours[k], want[k]) for k in want) and ours.keys() == want.keys()
    assert any(not np.array_equal(ours[k], init[k]) for k in ours)
    t = Trainer(dataclasses.replace(cfg, checkpoint_path=str(tmp_path), model_dir=str(tmp_path / "m2")), device="cpu")
    with pytest.raises(IsADirectoryError, match="tools/orbax_to_npz.py"):
        t.init_state()


def test_model_scope_rename_restores_nothing_in_both():
    """The JAX trainer's rename {'backbone': checkpoint_model_scope} asks for
    'scope/...' keys, while the importers emit 'backbone/...': with a model
    scope set, nothing is restored, in JAX and in the port alike."""
    sd = seeded_vgg(2)
    source = torch_vgg_to_flat(sd)
    params = unflatten_params({k: np.zeros_like(v) for k, v in source.items()})
    rename = {"backbone": "ron_320_vgg"}
    ours = flatten_params(warm_start_params(params, source, rename_map=rename, verbose=False))
    theirs = jax_ckpt.flatten_params(jax_ckpt.warm_start_params(
        jax_ckpt.unflatten_params({k: np.zeros_like(v) for k, v in source.items()}), source, rename_map=rename,
        verbose=False))
    assert all(not ours[k].any() and not theirs[k].any() for k in source)
