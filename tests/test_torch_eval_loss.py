"""Eval-time losses: the streaming evaluator's `loss/*` metrics against the
JAX package's `StreamingEvaluator(loss_config=...)`, and the open check of
how the eval-step loss of a fixed batch moves while it is trained on, in
JAX and in the port side by side. On the CPU.

Tolerances: the evaluator's losses within 1e-4 relative (RON: the same
draws on both sides, the JAX evaluator's `PRNGKey(batch index)`; SSD draws
nothing), its mAP within 1e-6. The multi-step check compares the direction
and size of each loss's change, not the bits: float32 runs of a RON step
part at the percent level within a few steps at lr 1e-3 (a ReLU within
roundoff of 0 flips and a train-mode BatchNorm amplifies it;
`test_torch_train.py`), so each change must have JAX's sign and lie within
20% of JAX's change.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.eval import StreamingEvaluator as JaxStreamingEvaluator
from ron_tensorflow_tpu.inference.detector import DetectionConfig as JaxDetectionConfig
from ron_tensorflow_tpu.losses.ron import RonLossConfig as JaxRonLossConfig
from ron_tensorflow_tpu.losses.ssd import SsdLossConfig as JaxSsdLossConfig
from ron_tensorflow_tpu.models import ssd as jax_ssd
from ron_tensorflow_tpu.models.ron import RON as JaxRON
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.ops.encode import TargetEncoder as JaxTargetEncoder
from ron_tensorflow_tpu.train import optimizer as jax_opt
from ron_tensorflow_tpu.train import state as jax_state
from ron_tensorflow_tpu.train.checkpoint import unflatten_params

from ron_tensorflow_tpu_torch.eval import StreamingEvaluator
from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig
from ron_tensorflow_tpu_torch.losses.ron import RonLossConfig
from ron_tensorflow_tpu_torch.losses.ssd import SsdLossConfig
from ron_tensorflow_tpu_torch.models import get_network
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC
from ron_tensorflow_tpu_torch.models.testing import seeded_flax_params
from ron_tensorflow_tpu_torch.ops.encode import TargetEncoder
from ron_tensorflow_tpu_torch.train import optimizer as port_opt
from ron_tensorflow_tpu_torch.train.state import create_train_state, detection_loss_fn, make_eval_step, make_train_step
from ron_tensorflow_tpu_torch.weights import from_jax_params
from test_torch_train import loss_draws, tiny_batch

LOSS_RTOL = 1e-4
MAP_TOL = 1e-6
CHANGE_RTOL = 0.2
STEPS = 10


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jvars(params, stats):
    out = {"params": jax.tree.map(jnp.asarray, unflatten_params(params))}
    if stats:
        out["batch_stats"] = jax.tree.map(jnp.asarray, unflatten_params(stats))
    return out


def eval_batches(rng, n_batches, b, hw, g=3):
    """Whitened images with gts; label 0 pads."""
    out = []
    for _ in range(n_batches):
        c = rng.uniform(0.2, 0.8, (b, g, 2))
        s = rng.uniform(0.1, 0.5, (b, g, 2))
        boxes = np.concatenate([c - s / 2, c + s / 2], -1).clip(0, 1).astype(np.float32)
        labels = rng.integers(1, 21, (b, g)).astype(np.int32)
        labels[:, -1] = 0
        out.append({"image": (rng.uniform(0, 255, (b, *hw, 3)) - 120).astype(np.float32), "gt_labels": labels,
                    "gt_boxes": boxes, "gt_difficult": np.zeros((b, g), np.int32)})
    return out


def ron_eval_draws(bi, shape):
    """The draws JAX's evaluator gives the RON loss of batch bi:
    PRNGKey(bi) -> (k_obj, k_cls) -> two uniforms (losses/ron.py:90)."""
    return torch.as_tensor(np.stack([np.asarray(jax.random.uniform(k, shape)) for k in
                                     jax.random.split(jax.random.PRNGKey(bi))]))


@pytest.mark.parametrize("family", ["ron", "ssd"])
def test_streaming_evaluator_losses_match_jax(family):
    rng = np.random.default_rng(5)
    if family == "ron":
        model, spec = get_network("ron_tiny_vgg")
        jmodel, jspec = JaxRON(spec=JAX_TINY_SPEC), JAX_TINY_SPEC
        loss_cfg, jloss_cfg = RonLossConfig(), JaxRonLossConfig()
        det_kw = dict(top_k=64, keep_top_k=16, objectness_threshold=0.0)
        batches = eval_batches(rng, 3, 2, (64, 64))
    else:  # the SSD eval preset's detection values (presets.py:18-41)
        model, spec = get_network("ssd_300_vgg")
        jmodel, jspec = jax_ssd.SSD(spec=jax_ssd.SSD_300_SPEC), jax_ssd.SSD_300_SPEC
        loss_cfg, jloss_cfg = SsdLossConfig(), JaxSsdLossConfig()
        det_kw = dict(select_threshold=0.01, objectness_threshold=0.0, top_k=400, keep_top_k=200, nms_threshold=0.45)
        batches = eval_batches(rng, 2, 1, (300, 300))
    params, stats = seeded_flax_params(model, seed=6)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    with jax.default_matmul_precision("highest"):
        ref = JaxStreamingEvaluator(jmodel, jspec, JaxDetectionConfig(**det_kw), loss_config=jloss_cfg).run(
            jvars(params, stats), iter(batches), log_every=0)
    ev = StreamingEvaluator(model, spec, DetectionConfig(**det_kw), device="cpu", loss_config=loss_cfg)
    n = spec.anchor_layout().num_anchors
    draws = [ron_eval_draws(bi, (len(b["image"]), n)) for bi, b in enumerate(batches)] if family == "ron" else None
    got = ev.run(iter(batches), log_every=0, loss_draws=draws)
    loss_keys = sorted(k for k in ref[3] if k.startswith("loss/"))
    assert loss_keys == sorted(k for k in got[3] if k.startswith("loss/")) and loss_keys
    assert len(ev.batch_losses) == len(batches)
    for k in loss_keys:
        np.testing.assert_allclose(got[3][k], ref[3][k], rtol=LOSS_RTOL, err_msg=k)
        assert got[3][k] == pytest.approx(np.mean([b[k] for b in ev.batch_losses]))
    np.testing.assert_allclose(got[0], ref[0], atol=MAP_TOL)
    np.testing.assert_allclose(got[1], ref[1], atol=MAP_TOL)
    if family == "ron":
        # without draws, a generator seeded by the batch index: the same draws every run
        again = StreamingEvaluator(model, spec, DetectionConfig(**det_kw), device="cpu", loss_config=loss_cfg)
        a = again.run(iter(batches), log_every=0)[3]
        b = again.run(iter(batches), log_every=0)[3]
        assert all(a[k] == b[k] for k in loss_keys)
    # the loss of every batch comes from the forward that made its detections
    assert StreamingEvaluator(model, spec, DetectionConfig(**det_kw), device="cpu").run(
        iter(batches), log_every=0)[0] == got[0]


def loss_trajectories(jmodel, model, spec, params, stats, batch, steps=STEPS):
    """ROADMAP Queue 3 item 2: over `steps` f32 steps on one fixed batch
    (the TrainConfig optimizer: momentum, lr 1e-3, weight decay), how the
    batch's eval-step loss (inference BatchNorm, the running statistics)
    and its train-mode loss (batch statistics) move, in JAX's
    `make_train_step`/`make_eval_step` and the port's, with the same
    weights, batch and loss draws (JAX's, from one fixed key every step).
    The train-mode loss at given parameters is what the next step reports.
    Returns {side: ([eval before, after], [train before, after])}."""
    b = len(batch["image"])
    n = spec.anchor_layout().num_anchors
    rng = jax.random.PRNGKey(0)
    opt = dict(optimizer="momentum", learning_rate=1e-3, learning_rate_decay_type="fixed", weight_decay=5e-4)

    jenc = JaxTargetEncoder(spec.anchor_layout(), spec.img_shape, 0.5, 0.3)
    jtx = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**opt))
    v = jvars(params, stats)
    jst = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                               opt_state=jtx.init(v["params"]))
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    jstep = jax.jit(jax_state.make_train_step(jmodel, jenc, jtx, JaxRonLossConfig()))
    jeval = jax.jit(jax_state.make_eval_step(jmodel, jenc, JaxRonLossConfig()))
    rng_loss = jax.random.split(rng)[0]  # the key the train step gives its loss
    with jax.default_matmul_precision("highest"):
        jax_eval = [float(jeval(jst, jb, rng_loss)[1]["loss/total"])]
        jax_train = []
        for _ in range(steps):
            jst, m = jstep(jst, jb, rng)
            jax_train = jax_train or [float(m["loss/total"])]
        jax_eval.append(float(jeval(jst, jb, rng_loss)[1]["loss/total"]))
        jax_train.append(float(jstep(jst, jb, rng)[1]["loss/total"]))

    enc = TargetEncoder(spec.anchor_layout(), spec.img_shape, 0.5, 0.3)
    tx = port_opt.make_optimizer(port_opt.OptimizerConfig(**opt), model)
    st = create_train_state(model, tx)
    tb = {k: torch.as_tensor(x) for k, x in batch.items()}
    step, eval_step = make_train_step(model, enc, tx), make_eval_step(model, enc)
    draws = loss_draws(rng, (b, n))
    port_eval = [float(eval_step(st, tb, draws=draws)[1]["loss/total"])]
    port_train = []
    for _ in range(steps):
        st, m = step(st, tb, draws=draws)
        port_train = port_train or [float(m["loss/total"])]
    port_eval.append(float(eval_step(st, tb, draws=draws)[1]["loss/total"]))
    with torch.no_grad():  # the next step's train-mode loss, without its update
        saved = {k: t.clone() for k, t in model.named_buffers()}
        out = model(tb["image"], train=True)
        total, _ = detection_loss_fn(RonLossConfig())(out, enc.batched(tb["gt_labels"], tb["gt_boxes"],
                                                                        tb["gt_valid"]), draws=draws)
        for k, t in model.named_buffers():
            t.copy_(saved[k])
    port_train.append(float(total))
    print(f"eval-step loss: JAX {jax_eval[0]:.4f} -> {jax_eval[1]:.4f}, port {port_eval[0]:.4f} -> "
          f"{port_eval[1]:.4f}; train-mode loss: JAX {jax_train[0]:.4f} -> {jax_train[1]:.4f}, port "
          f"{port_train[0]:.4f} -> {port_train[1]:.4f}")
    return {"jax": (jax_eval, jax_train), "port": (port_eval, port_train)}


def assert_moves_alike(res):
    for i, name in enumerate(("eval-step", "train-mode")):
        j, p = res["jax"][i], res["port"][i]
        np.testing.assert_allclose(p[0], j[0], rtol=LOSS_RTOL, err_msg=name)
        d_jax, d_port = j[1] - j[0], p[1] - p[0]
        assert np.sign(d_port) == np.sign(d_jax) != 0, (name, d_jax, d_port)
        assert abs(d_port - d_jax) <= CHANGE_RTOL * abs(d_jax), (name, d_jax, d_port)
    assert all(train[1] < train[0] for _, train in res.values())


def test_eval_step_loss_moves_as_in_jax_over_ten_steps():
    """The tiny RON with seeded weights and BatchNorm statistics: on this
    batch both losses fall, alike in JAX and the port."""
    model = RON(RON_TINY_SPEC)
    params, stats = seeded_flax_params(model, seed=13)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    assert_moves_alike(loss_trajectories(JaxRON(spec=JAX_TINY_SPEC), model, RON_TINY_SPEC, params, stats,
                                         tiny_batch(4, b=4)))


@pytest.mark.slow
def test_trained_ron320_eval_step_loss_moves_as_in_jax():
    """RON-320 with the trained fixture's weights on its four demo images
    (gts from their realtime references), as `chip_smoke.py` phase "train"
    trains it: the setting where the port's eval-step loss rises on the card
    while its train-mode loss falls. JAX's moves the same way."""
    from ron_tensorflow_tpu.models.ron import RON_320_SPEC as JAX_320_SPEC
    from ron_tensorflow_tpu_torch.data.preprocess import eval_preprocess
    from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC
    from ron_tensorflow_tpu_torch.weights import load_trained_fixture

    fixture = "tests/fixtures/e2e_parity_trained.npz"
    params, stats = ({k: v.numpy() for k, v in d.items()} for d in load_trained_fixture(fixture))
    model = RON(RON_320_SPEC)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    fx = np.load(fixture)
    refs = [(fx[f"img_{i}_rt_published_labels"], fx[f"img_{i}_rt_published_boxes"]) for i in "1234"]
    g = max(len(lab) for lab, _ in refs)
    labels, boxes = np.zeros((4, g), np.int32), np.zeros((4, g, 4), np.float32)
    for i, (lab, bx) in enumerate(refs):
        labels[i, :len(lab)], boxes[i, :len(lab)] = lab, bx
    images = np.stack([eval_preprocess(torch.as_tensor(fx[f"img_{i}_pixels"]).float() / 255.0, (320, 320))[0].numpy()
                       for i in "1234"])
    batch = {"image": images, "gt_labels": labels, "gt_boxes": boxes, "gt_valid": labels > 0}
    res = loss_trajectories(JaxRON(spec=JAX_320_SPEC), model, RON_320_SPEC, params, stats, batch)
    assert_moves_alike(res)
