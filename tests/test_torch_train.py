"""The port's train mode, train step and eval step against the JAX package's,
on the CPU, with the same numpy-made weights, batch and random draws.

Tolerances (float32 on both sides; the sums run in another order):
- one BatchNorm in train mode: outputs and running statistics within 1e-5
  relative in f32; in bf16 (and its fast normalize) within one bf16 rounding
  of the output (2^-8 relative) and 1e-5 on the f32 statistics;
- three tiny RON steps: the losses and counts within 1e-4 relative,
  grad_norm within 1e-3; parameters, batch statistics and EMA within 1e-5
  of each tensor's largest magnitude; the three steps' parameter update
  (after - before) within 1e-2 in L2 over all tensors. The learning rate is
  small (1e-5) because a RON step is discontinuous at its ReLUs: a value
  within float32 roundoff of 0 flips, and a train-mode BatchNorm over a few
  values amplifies the flip, so at lr 1e-3 two runs of JAX alone whose
  parameters differ by 1e-7 (relative) part by 0.3% in grad_norm and 1.7%
  in the update within three steps. Measured at lr 1e-5: the losses within
  4e-6, grad_norm within 2.7e-4, the update within 4.2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.losses.ron import RonLossConfig as JaxRonLossConfig
from ron_tensorflow_tpu.models import layers as jax_layers
from ron_tensorflow_tpu.models.ron import RON as JaxRON
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.ops.encode import TargetEncoder as JaxTargetEncoder
from ron_tensorflow_tpu.train import optimizer as jax_opt
from ron_tensorflow_tpu.train import state as jax_state
from ron_tensorflow_tpu.train.checkpoint import flatten_params, unflatten_params

from ron_tensorflow_tpu_torch.losses.ron import RonLossConfig
from ron_tensorflow_tpu_torch.models import get_network, layers
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC, RON_TINY_SPEC, SSD_300_SPEC, SSD_512_SPEC
from ron_tensorflow_tpu_torch.ops.encode import TargetEncoder
from ron_tensorflow_tpu_torch.train import optimizer as port_opt
from ron_tensorflow_tpu_torch.train.state import create_train_state, make_eval_step, make_train_step, pinned_precision
from ron_tensorflow_tpu_torch.weights import from_jax_params, to_jax_params

METRIC_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-3
STATE_TOL = 1e-5
UPDATE_TOL = 1e-2
OPT = dict(optimizer="momentum", learning_rate=1e-5, learning_rate_decay_type="fixed", weight_decay=5e-4)
EMA = 0.9


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: its CPU steps share the
    cores with the other test workers, and eight spinning threads a worker
    slow all of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.as_tensor(np.asarray(a, np.float32)).permute(0, 3, 1, 2)


# --------------------------------------------------------------------------- #
# BatchNorm in train mode


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16 fast normalize", "f32 fast normalize (ignored)"])
def test_batchnorm_train_mode_matches_flax(mode):
    rng = np.random.default_rng(0)
    x = (rng.normal(0.5, 2.0, (3, 5, 4, 6))).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.normal(0, 1, 6).astype(np.float32)
    mean0, var0 = rng.normal(0, 0.1, 6).astype(np.float32), rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bf16 = mode.startswith("bf16")
    fast = "fast" in mode
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    bn = jax_layers.BatchNorm(use_running_average=False)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    try:
        jax_layers.set_bn_fast_normalize(fast)
        ref, mutated = bn.apply(variables, jx, mutable=["batch_stats"])
    finally:
        jax_layers.set_bn_fast_normalize(False)
    port = layers.BatchNorm(6)
    port.fast_normalize = fast
    port.load_state_dict(from_jax_params({"scale": scale, "bias": bias}, {"mean": mean0, "var": var0}))
    tx = nchw(x).to(torch.bfloat16 if bf16 else torch.float32)
    got = port(tx, train=True).permute(0, 2, 3, 1)
    assert got.dtype == tx.dtype
    ref = np.asarray(ref.astype(jnp.float32))
    rtol = 2.0 ** -8 if bf16 else 1e-5
    np.testing.assert_allclose(got.float().detach().numpy(), ref, rtol=rtol, atol=rtol * np.abs(ref).max())
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(mutated["batch_stats"]["var"]), rtol=1e-5,
                               atol=1e-6)


def test_batchnorm_follows_the_train_argument_not_module_training():
    """A module is built with training=True; without `train=True` it still
    normalizes with the running statistics and leaves them alone."""
    bn = layers.BatchNorm(4)
    assert bn.training
    with torch.no_grad():
        bn.running_mean.fill_(0.5)
        bn.running_var.fill_(4.0)
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    y = bn(x)
    torch.testing.assert_close(y, (x - 0.5) / torch.sqrt(torch.tensor(4.0 + 1e-5)))
    assert float(bn.running_mean[0]) == 0.5 and float(bn.running_var[0]) == 4.0
    bn(x, train=True)
    assert float(bn.running_mean[0]) != 0.5
    # biased variance, momentum 0.997 (not F.batch_norm's unbiased one and its complement)
    var = x.float().var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.997 * 4.0 + 0.003 * var)


# --------------------------------------------------------------------------- #
# the train step


def tiny_weights(seed=4):
    """Numpy-made flax params and batch stats of the tiny RON."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: JaxRON(spec=JAX_TINY_SPEC).init(jax.random.PRNGKey(0),
                                                                   jnp.zeros((1, 64, 64, 3)), train=False))
    params = {}
    for k, v in flatten_params(shapes["params"]).items():
        if k.endswith("kernel"):
            v = rng.normal(0.0, 1.0, v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        elif k.endswith("scale"):
            v = rng.uniform(0.5, 1.5, v.shape)
        else:
            v = rng.normal(0.0, 0.1, v.shape)
        params[k] = v.astype(np.float32)
    stats = {k: (rng.normal(0.0, 0.1, v.shape) if k.endswith("mean") else rng.uniform(0.5, 1.5, v.shape))
             .astype(np.float32) for k, v in flatten_params(shapes["batch_stats"]).items()}
    return params, stats


def tiny_batch(seed=0, b=4):
    """b images with up to 4 gts each. The tiny RON's block7 map is 1x1, so
    its train-mode BatchNorms normalize over b values; at b = 2 every output
    is +-1 and the gradients into those layers are roundoff."""
    rng = np.random.default_rng(seed)
    g = 4
    boxes = np.zeros((b, g, 4), np.float32)
    for i in range(b):
        for j in range(g):
            y0, x0 = rng.uniform(0.0, 0.5, 2)
            h, w = rng.uniform(0.2, 0.5, 2)
            boxes[i, j] = (y0, x0, y0 + h, x0 + w)
    return {
        # each image its own contrast and brightness, so that the deep 1x1
        # features differ between images: on images alike, block7's
        # train-mode BatchNorms see a batch variance near eps
        "image": (rng.uniform(-128, 128, (b, 64, 64, 3)) * rng.uniform(0.1, 1.0, (b, 1, 1, 1))
                  + rng.uniform(-80, 80, (b, 1, 1, 3))).astype(np.float32),
        "gt_labels": rng.integers(1, 21, (b, g)).astype(np.int32),
        "gt_boxes": boxes,
        "gt_valid": np.arange(g)[None, :] < rng.integers(1, g + 1, (b, 1)),
    }


def loss_draws(rng, shape):
    """The draws JAX's train step gives its loss: rng -> (rng_loss, _) ->
    (k_obj, k_cls) -> two uniforms (state.py:117, losses/ron.py:90)."""
    rng_loss, _ = jax.random.split(rng)
    return torch.as_tensor(np.stack([np.asarray(jax.random.uniform(k, shape, jnp.float32))
                                     for k in jax.random.split(rng_loss)]))


def jax_setup(params, stats):
    model = JaxRON(spec=JAX_TINY_SPEC)
    enc = JaxTargetEncoder(JAX_TINY_SPEC.anchor_layout(), JAX_TINY_SPEC.img_shape, 0.5, 0.3)
    tx = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT))
    p = jax.tree.map(jnp.asarray, unflatten_params(params))
    state = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                                 batch_stats=jax.tree.map(jnp.asarray, unflatten_params(stats)),
                                 opt_state=tx.init(p), ema_params=jax.tree.map(jnp.copy, p))
    return model, enc, tx, state


def port_setup(params, stats, dtype=torch.float32, **kw):
    model = RON(RON_TINY_SPEC, dtype=dtype, **kw)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    enc = TargetEncoder(RON_TINY_SPEC.anchor_layout(), RON_TINY_SPEC.img_shape, 0.5, 0.3)
    tx = port_opt.make_optimizer(port_opt.OptimizerConfig(**OPT), model)
    return model, enc, tx, create_train_state(model, tx, ema=True)


def assert_tree_close(got, ref, label):
    assert got.keys() == ref.keys(), label
    for k, r in ref.items():
        r = np.asarray(r)
        np.testing.assert_allclose(got[k], r, rtol=STATE_TOL, atol=STATE_TOL * max(float(np.abs(r).max()), 1e-30),
                                   err_msg=f"{label} {k}")


def test_three_tiny_f32_steps_match_jax():
    params, stats = tiny_weights()
    batch = tiny_batch()
    jmodel, jenc, jtx, jst = jax_setup(params, stats)
    jstep = jax.jit(jax_state.make_train_step(jmodel, jenc, jtx, JaxRonLossConfig(), EMA))
    model, enc, tx, st = port_setup(params, stats)
    step = make_train_step(model, enc, tx, RonLossConfig(), EMA)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    n = RON_TINY_SPEC.anchor_layout().num_anchors
    for i in range(3):
        rng = jax.random.PRNGKey(10 + i)
        jst, ref = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        st, got = step(st, tbatch, draws=loss_draws(rng, (4, n)))
        assert got.keys() == ref.keys()
        for k in ref:
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else METRIC_RTOL
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol, err_msg=f"step {i} {k}")
    assert st.step == int(jst.step) == 3
    assert float(got["counts/positives"]) > 0 and float(got["loss/localization"]) > 0
    got_p, ref_p = to_jax_params(model, model.named_parameters()), flatten_params(jst.params)
    assert_tree_close(got_p, ref_p, "params")
    diff = sum(float(np.sum(((got_p[k] - np.asarray(ref_p[k])).astype(np.float64)) ** 2)) for k in ref_p)
    moved = sum(float(np.sum((np.asarray(ref_p[k], np.float64) - params[k]) ** 2)) for k in ref_p)
    assert moved > 0 and np.sqrt(diff / moved) <= UPDATE_TOL, np.sqrt(diff / moved)
    assert_tree_close(to_jax_params(model, model.named_buffers()), flatten_params(jst.batch_stats), "batch stats")
    assert_tree_close(to_jax_params(model, st.ema_params.items()), flatten_params(jst.ema_params), "EMA")


def test_eval_step_matches_jax():
    params, stats = tiny_weights(5)
    batch = tiny_batch(1)
    jmodel, jenc, _, jst = jax_setup(params, stats)
    rng = jax.random.PRNGKey(3)
    _, ref = jax.jit(jax_state.make_eval_step(jmodel, jenc, JaxRonLossConfig()))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    model, enc, _, st = port_setup(params, stats)
    k_obj, k_cls = jax.random.split(rng)
    n = RON_TINY_SPEC.anchor_layout().num_anchors
    draws = torch.as_tensor(np.stack([np.asarray(jax.random.uniform(k, (4, n))) for k in (k_obj, k_cls)]))
    _, got = make_eval_step(model, enc)(st, {k: torch.as_tensor(v) for k, v in batch.items()}, draws=draws)
    for k in ref:
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else METRIC_RTOL
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol, err_msg=k)
    torch.testing.assert_close(model.block7_box.conv.bn.running_mean,
                               torch.as_tensor(stats["block7_box/conv/bn/mean"]), rtol=0, atol=0)


def test_f32_backward_runs_under_full_f32_convs():
    """The f32 train step's backward convolutions run with cuDNN TF32 off
    whatever the caller's flag, which comes back afterwards; a bf16 model's
    step leaves the flag alone."""
    params, stats = tiny_weights(6)
    batch = {k: torch.as_tensor(v) for k, v in tiny_batch(2, b=2).items()}
    model, enc, tx, st = port_setup(params, stats)
    seen = []
    model.backbone.conv1_1.conv.weight.register_hook(lambda g: seen.append(torch.backends.cudnn.allow_tf32) and None)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        make_train_step(model, enc, tx)(st, batch, generator=torch.Generator().manual_seed(0))
        assert torch.backends.cudnn.allow_tf32 is True and seen == [False]
        with pinned_precision(RON(RON_TINY_SPEC, dtype=torch.bfloat16)):
            assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_fused_block1_gradient_inside_a_train_step():
    """A bf16 step with K-B (its plain version here): the conv1_* gradients
    are autograd through `block1_reference` of the step's own block-1
    inputs and of the gradient that reaches block 1's output, bit for bit.
    (Against the model's own unfused convs, which add the bias inside the
    bf16 convolution, they differ by bf16 rounding at ReLU and pool ties:
    chip_smoke.py holds that at RON-320 and batch 14 on the card.)"""
    from ron_tensorflow_tpu_torch.kernels.fused_conv_pool import block1_reference

    params, stats = tiny_weights(7)
    batch = {k: torch.as_tensor(v) for k, v in tiny_batch(3, b=2).items()}
    model, enc, tx, st = port_setup(params, stats, dtype=torch.bfloat16, fuse_block1=True)
    bb = model.backbone
    seen, inner = {}, bb._block1

    def keep(key):
        def hook(grad):  # records the gradient and leaves it alone
            seen.setdefault(key, grad.detach().clone())
        return hook

    def block1(x):
        seen["x"] = x.detach()
        out = inner(x)
        out.register_hook(keep("g_out"))
        return out

    bb._block1 = block1
    weights = (bb.conv1_1.conv.weight, bb.conv1_1.conv.bias, bb.conv1_2.conv.weight, bb.conv1_2.conv.bias)
    for i, w in enumerate(weights):
        w.register_hook(keep(i))
    make_train_step(model, enc, tx)(st, batch, generator=torch.Generator().manual_seed(1))
    got = [seen[i] for i in range(4)]
    # back to the weights the step differentiated at (it has updated them)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    x = seen["x"].permute(0, 2, 3, 1).contiguous()
    leaves = [w.detach().clone().requires_grad_() for w in weights]
    out = block1_reference(x, *leaves).permute(0, 3, 1, 2)
    ref = torch.autograd.grad(out, leaves, seen["g_out"])
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_glorot_init_like_flax():
    model, _ = get_network("ron_tiny_vgg")
    st = create_train_state(model, port_opt.make_optimizer(port_opt.OptimizerConfig(), model),
                            generator=torch.Generator().manual_seed(0))
    w = model.backbone.conv2_1.conv.weight  # [128, 64, 3, 3]
    limit = np.sqrt(6.0 / (9 * 64 + 9 * 128))
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.95 * limit
    np.testing.assert_allclose(float(w.std()), limit / np.sqrt(3.0), rtol=0.02)
    d = model.block6_reverse.deconv_right.weight  # flax [2, 2, 512, 512]
    assert float(d.abs().max()) <= np.sqrt(6.0 / (4 * 512 + 4 * 512))
    assert float(model.backbone.conv2_1.conv.bias.abs().max()) == 0.0
    bn = model.block7_box.conv.bn
    assert float((bn.weight - 1).abs().max()) == 0 and float(bn.bias.abs().max()) == 0
    assert st.step == 0 and st.ema_params is None and st.opt_state["count"] == 0


def test_get_network_registry():
    """Every registered name builds its model; the output shapes come from a
    forward on the meta device (shapes only, no arithmetic)."""
    model, spec = get_network("ron_320_vgg", dtype=torch.bfloat16)
    assert spec is RON_320_SPEC and model.dtype == torch.bfloat16
    cases = {"ron_320_vgg_heavy": (RON_320_SPEC, 21250), "ssd_300_vgg": (SSD_300_SPEC, 8732),
             "ssd_512_vgg": (SSD_512_SPEC, 24564), "ssd_300_vgg_caffe": (SSD_300_SPEC, 8732),
             "ssd_512_vgg_caffe": (SSD_512_SPEC, 24564)}
    for name, (want_spec, n) in cases.items():
        with torch.device("meta"):
            model, spec = get_network(name)
            out = model(torch.empty(2, *spec.img_shape, 3))
        assert spec is want_spec and spec.anchor_layout().num_anchors == n
        assert type(model).__name__ == ("RON" if name.startswith("ron") else "SSD")
        assert out.logits.shape == out.predictions.shape == (2, n, 21) and out.locations.shape == (2, n, 4)
        assert out.objness_pred.shape == (2, n) and out.objness_logits.shape == (2, n, 2)
    heavy = get_network("ron_320_vgg_heavy")[0].backbone
    assert heavy.fc6.conv.weight.shape == (4096, 512, 7, 7) and heavy.fc7.conv.weight.shape == (4096, 4096, 1, 1)
    with pytest.raises(ValueError, match="unknown network"):
        get_network("resnet")


@pytest.mark.slow
def test_ron320_f32_step_matches_jax():
    """One full-width RON-320 step (batch 2, numpy-made weights) against
    JAX's: the losses within 1e-4 relative, grad_norm within 1e-3 (measured
    1.1e-4)."""
    rng = np.random.default_rng(8)
    from ron_tensorflow_tpu.models.ron import RON_320_SPEC as JAX_320_SPEC

    jmodel = JaxRON(spec=JAX_320_SPEC)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 320, 320, 3)), train=False))
    params = {k: (rng.normal(0, 1, v.shape) / np.sqrt(np.prod(v.shape[:-1])) if k.endswith("kernel")
                  else np.ones(v.shape) if k.endswith("scale") else np.zeros(v.shape)).astype(np.float32)
              for k, v in flatten_params(shapes["params"]).items()}
    stats = {k: (np.zeros if k.endswith("mean") else np.ones)(v.shape, np.float32)
             for k, v in flatten_params(shapes["batch_stats"]).items()}
    batch = tiny_batch(4, b=2)
    batch["image"] = (rng.uniform(0, 255, (2, 320, 320, 3)) - 120).astype(np.float32)
    enc = JaxTargetEncoder(JAX_320_SPEC.anchor_layout(), (320, 320), 0.56, 0.3)
    tx = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT))
    p = jax.tree.map(jnp.asarray, unflatten_params(params))
    jst = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                               batch_stats=jax.tree.map(jnp.asarray, unflatten_params(stats)), opt_state=tx.init(p))
    rng_k = jax.random.PRNGKey(0)
    _, ref = jax.jit(jax_state.make_train_step(jmodel, enc, tx, JaxRonLossConfig()))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()}, rng_k)
    model = RON(RON_320_SPEC)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    penc = TargetEncoder(RON_320_SPEC.anchor_layout(), (320, 320), 0.56, 0.3)
    ptx = port_opt.make_optimizer(port_opt.OptimizerConfig(**OPT), model)
    _, got = make_train_step(model, penc, ptx)(create_train_state(model, ptx),
                                               {k: torch.as_tensor(v) for k, v in batch.items()},
                                               draws=loss_draws(rng_k, (2, RON_320_SPEC.anchor_layout().num_anchors)))
    for k in ref:
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else METRIC_RTOL
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol, err_msg=k)
