"""The port's space-to-depth stem (`models/vgg.py::s2d_block1`) and its
blocks-1-2 remat against the JAX package's, case for case with
tests/test_s2d_stem.py, on the CPU with the same numpy-made inputs and
weights on both sides.

Tolerances (float32 everywhere; JAX under `default_matmul_precision
("highest")`): the stem is exact up to summation order, so block 1 within
1e-5 (as JAX holds its own stem to its plain block 1), its parameter
gradients within 1e-4 relative and 1e-5 absolute, the 13-conv backbone,
RON and SSD within 1e-4 of each output's largest magnitude (1e-5 relative
where the port's stem is held to the port's plain block 1, the same convs
in another form); remat is a scheduling change, so the port's remat
forward and gradients equal the port's plain ones bit for bit, and JAX's
within 1e-4. A tiny Trainer step with `s2d_stem` against the plain one: the
loss within 1e-5 relative, each gradient within 1e-4 of its tensor's
largest magnitude (the gates of chip_smoke.py's phase "stem").
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.models import ssd as jax_ssd
from ron_tensorflow_tpu.models import vgg as jax_vgg
from ron_tensorflow_tpu.train.checkpoint import flatten_params, unflatten_params

from ron_tensorflow_tpu_torch.models import get_network
from ron_tensorflow_tpu_torch.models.ron import RON
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC
from ron_tensorflow_tpu_torch.models.testing import scale_ssd_heads, seeded_flax_params
from ron_tensorflow_tpu_torch.models.vgg import (
    VGG16Backbone,
    phase_output_kernel,
    s2d_block1,
    s2d_stem_supported,
)
from ron_tensorflow_tpu_torch.train.trainer import Trainer
from ron_tensorflow_tpu_torch.weights import from_jax_params, to_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_model import _whitened, tiny  # noqa: E402,F401  (the module fixture)
from test_torch_trainer import host_batches, tiny_config  # noqa: E402

BLOCK1_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
NET_TOL = 1e-4  # of each output's largest magnitude
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_TOL = 1e-4  # of each gradient tensor's largest magnitude
LOSS_KEY = "loss/total"


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: its CPU forwards share the
    cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.as_tensor(np.asarray(a, np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def oihw(w_hwio):
    return torch.as_tensor(np.asarray(w_hwio)).permute(3, 2, 0, 1).contiguous()


def block1_params(rng, cin=3, c=8):
    """The draws of tests/test_s2d_stem.py::_rand_block1_params, HWIO."""
    w1 = (rng.normal(size=(3, 3, cin, c)) * 0.2).astype(np.float32)
    b1 = rng.normal(size=(c,)).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, c, c)) * 0.2).astype(np.float32)
    b2 = rng.normal(size=(c,)).astype(np.float32)
    return w1, b1, w2, b2


def port_params(w1, b1, w2, b2, grad=False):
    out = [oihw(w1), torch.as_tensor(b1), oihw(w2), torch.as_tensor(b2)]
    return [t.requires_grad_(grad) for t in out]


def jax_variables(params):
    return {"params": jax.tree.map(jnp.asarray, unflatten_params(params))}


def assert_outputs_close(got, ref, tol=NET_TOL, label=""):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, label
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * float(np.abs(ref).max()), err_msg=label)


@pytest.mark.parametrize("hw", [(20, 20), (12, 16), (6, 6)])
def test_s2d_block1_matches_jax(hw):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    params = block1_params(rng)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_vgg.s2d_block1(jnp.asarray(x), *map(jnp.asarray, params)))
    got = nhwc(s2d_block1(nchw(x), *port_params(*params)))
    assert got.shape == ref.shape == (2, hw[0] // 2, hw[1] // 2, 8)
    np.testing.assert_allclose(got, ref, rtol=BLOCK1_TOL, atol=BLOCK1_TOL)


def test_phase_output_kernel_matches_jax_structure():
    """The port's kernel is JAX's `_phase_output_kernel` in OIHW, value for
    value: K[(2p+q)Co+o, :, a, b] = w[o, :, a-p, b-q], 0 outside [0, 3)."""
    w = np.random.default_rng(1).normal(size=(3, 3, 2, 5)).astype(np.float32)
    ref = np.asarray(jax_vgg._phase_output_kernel(jnp.asarray(w)))  # [4, 4, Ci, 4Co]
    got = phase_output_kernel(oihw(w))
    assert got.shape == (20, 2, 4, 4)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), ref)
    wt = oihw(w).numpy()
    for p in range(2):
        for q in range(2):
            blk = got[(2 * p + q) * 5:(2 * p + q + 1) * 5].numpy()
            for a in range(4):
                for b in range(4):
                    want = wt[:, :, a - p, b - q] if 0 <= a - p < 3 and 0 <= b - q < 3 else 0.0
                    np.testing.assert_array_equal(blk[:, :, a, b], want)


def test_s2d_block1_parameter_gradients_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 12, 3)).astype(np.float32)
    params = block1_params(rng)
    with jax.default_matmul_precision("highest"):
        ref = jax.grad(lambda ps: jnp.sum(jnp.sin(jax_vgg.s2d_block1(jnp.asarray(x), *ps))))(
            tuple(map(jnp.asarray, params)))
    leaves = port_params(*params, grad=True)
    torch.sin(s2d_block1(nchw(x), *leaves)).sum().backward()
    for name, leaf, r in zip(("w1", "b1", "w2", "b2"), leaves, ref):
        r = np.asarray(r)
        g = leaf.grad.permute(2, 3, 1, 0).numpy() if r.ndim == 4 else leaf.grad.numpy()
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


@pytest.fixture(scope="module")
def backbone_weights():
    params, _ = seeded_flax_params(VGG16Backbone(), seed=11, gain=2 ** 0.5)
    x = np.random.default_rng(12).normal(size=(1, 64, 64, 3)).astype(np.float32)
    return params, x


def backbone(params, **flags):
    model = VGG16Backbone(**flags)
    model.load_state_dict(from_jax_params(params, {}), strict=True)
    return model


def test_backbone_s2d_flag_matches_jax(backbone_weights):
    """The same parameters load with the flag on (names unchanged); the
    endpoints are JAX's with the flag, block1 left out, and the port's
    without it."""
    params, x = backbone_weights
    with jax.default_matmul_precision("highest"):
        ref = jax_vgg.VGG16Backbone(s2d_stem=True).apply(jax_variables(params), jnp.asarray(x))
    plain = backbone(params)
    s2d = backbone(params, s2d_stem=True)
    assert s2d.state_dict().keys() == plain.state_dict().keys()
    with torch.no_grad():
        got = s2d(nchw(x))
        plain_out = plain(nchw(x))
    assert set(got) == set(ref) == set(plain_out)
    for k in got:
        assert_outputs_close(nhwc(got[k]), ref[k], label=k)
        np.testing.assert_allclose(got[k].numpy(), plain_out[k].numpy(), rtol=1e-5,
                                   atol=1e-5 * float(plain_out[k].abs().max()), err_msg=k)


def test_backbone_remat12_forward_and_gradients(backbone_weights):
    """remat_blocks12 against the port's plain backbone (bit for bit) and
    JAX's remat backbone (within NET_TOL): the endpoints both emit (no
    block1, no block2), and the parameter gradients of sum(v^2) over them."""
    params, x = backbone_weights
    plain = backbone(params)
    remat = backbone(params, remat_blocks12=True)
    got = remat(nchw(x))
    ref_plain = plain(nchw(x))
    assert set(got) == set(ref_plain) - {"block2"}
    jmodel = jax_vgg.VGG16Backbone(remat_blocks12=True)
    jvars = jax_variables(params)
    with jax.default_matmul_precision("highest"):
        jref = jmodel.apply(jvars, jnp.asarray(x))
        jgrad = jax.grad(lambda p: sum(jnp.sum(v ** 2) for v in jmodel.apply({"params": p}, jnp.asarray(x)).values())
                         )(jvars["params"])
    assert set(jref) == set(got)
    for k in got:
        assert torch.equal(got[k], ref_plain[k]), k
        assert_outputs_close(nhwc(got[k]), jref[k], label=k)
    sum(v.pow(2).sum() for v in got.values()).backward()
    sum(ref_plain[k].pow(2).sum() for k in got).backward()
    port_grads = from_jax_params({k: np.asarray(v) for k, v in flatten_params(jgrad).items()}, {})
    for (name, p), (_, q) in zip(remat.named_parameters(), plain.named_parameters()):
        assert torch.equal(p.grad, q.grad), name
        r = port_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0, atol=NET_TOL * float(np.abs(r).max()), err_msg=name)


def test_ron_s2d_and_remat_forward_match_jax(tiny):
    """The tiny RON of test_torch_model.py with each flag against JAX's with
    the same flag, on the same parameters, BatchNorm statistics and whitened
    pixels (inference mode)."""
    jmodel, jvars, model, pixels = tiny
    x = _whitened(pixels)
    for flag in ("s2d_stem", "remat_blocks12"):
        with jax.default_matmul_precision("highest"):
            ref = jmodel.clone(**{flag: True}).apply(jvars, jnp.asarray(x), train=False)
        port = RON(RON_TINY_SPEC, **{flag: True})
        port.load_state_dict(model.state_dict(), strict=True)
        with torch.no_grad():
            got = port(torch.as_tensor(x))
        for field, g, r in zip(got._fields, got, ref):
            assert_outputs_close(g.numpy(), r, label=f"{flag} {field}")


def test_ssd300_s2d_forward_matches_jax():
    """SSD-300 with s2d_stem against JAX's SSD-300 with it, one image, on
    the weights of test_torch_ssd_model.py's `ssd300` (heads scaled to a
    logit std of 2.5, so the softmax is far from flat)."""
    plain, spec = get_network("ssd_300_vgg")
    params, _ = seeded_flax_params(plain, seed=300, gain=2 ** 0.5)
    plain.load_state_dict(from_jax_params(params, {}), strict=True)
    x = torch.as_tensor((np.random.default_rng(1).uniform(0, 255, (1, *spec.img_shape, 3)) - 120).astype(np.float32))
    with torch.no_grad():
        scale_ssd_heads(plain, x)
        model, _ = get_network("ssd_300_vgg", s2d_stem=True)
        model.load_state_dict(plain.state_dict(), strict=True)
        got, ref_plain = model(x), plain(x)
    params = to_jax_params(plain, plain.named_parameters())
    with jax.default_matmul_precision("highest"):
        ref = jax_ssd.SSD(spec=jax_ssd.SSD_300_SPEC, s2d_stem=True).apply(jax_variables(params), jnp.asarray(x.numpy()))
    for field in ("logits", "locations", "predictions"):
        assert_outputs_close(getattr(got, field).numpy(), getattr(ref, field), label=field)
        assert_outputs_close(getattr(got, field).numpy(), getattr(ref_plain, field).numpy(), label=f"port {field}")


def test_s2d_and_remat_guards():
    assert s2d_stem_supported(320, 320) and s2d_stem_supported(300, 300)
    assert not s2d_stem_supported(321, 320)
    with pytest.raises(ValueError, match="mutually exclusive"):
        VGG16Backbone(s2d_stem=True, fuse_block1=True)
    for flags in ({"fuse_block1": True}, {"s2d_stem": True}):
        with pytest.raises(ValueError, match="plain block-1/2 path"):
            VGG16Backbone(remat_blocks12=True, **flags)
        with pytest.raises(ValueError, match="plain block-1/2 path"):
            RON(RON_TINY_SPEC, remat_blocks12=True, **flags)
    with pytest.raises(ValueError, match="mutually exclusive"):
        get_network("ssd_300_vgg", s2d_stem=True, fuse_block1=True)
    with pytest.raises(ValueError, match="even spatial sizes"):
        VGG16Backbone(s2d_stem=True)(torch.zeros(1, 3, 9, 8))
    with pytest.raises(ValueError, match="3x3 only"):
        phase_output_kernel(torch.zeros(4, 4, 5, 5))


def test_trainer_step_with_s2d_stem_equals_the_plain_step(tmp_path, monkeypatch):
    """One f32 Trainer step of the tiny RON with `s2d_stem=true` and one
    without, from the same seed on the same host batch: the loss and every
    gradient agree (the s2d model is the plain one with block 1 reindexed);
    on a shape the stem does not take the Trainer keeps the model plain."""
    rows, grads = {}, {}
    for flag in (False, True):
        cfg = tiny_config(tmp_path / str(flag), s2d_stem=flag, max_steps=1, tensorboard=False)
        t = Trainer(cfg, device="cpu")
        assert t.model.backbone.s2d_stem is flag
        seen = grads[flag] = {}

        def keep(name, seen=seen):
            def hook(grad):  # records the gradient and leaves it alone
                seen.setdefault(name, grad.detach().clone())
            return hook

        for n, p in t.model.named_parameters():
            p.register_hook(keep(n))
        t.train(batches=iter([next(host_batches())]))
        rows[flag] = json.loads(open(Path(cfg.model_dir) / "metrics.jsonl").readline())
    loss, loss_s2d = rows[False][LOSS_KEY], rows[True][LOSS_KEY]
    assert abs(loss_s2d - loss) <= STEP_LOSS_RTOL * abs(loss)
    assert grads[True].keys() == grads[False].keys() and grads[True]
    for name, g in grads[False].items():
        err = float((grads[True][name] - g).abs().max())
        assert err <= STEP_GRAD_TOL * max(float(g.abs().max()), 1e-30), (name, err)
    # a shape the stem does not take: the model stays plain, fuse_block1 stays off too (JAX trainer.py:79-83)
    monkeypatch.setattr("ron_tensorflow_tpu_torch.train.trainer.s2d_stem_supported", lambda h, w: False)
    t = Trainer(tiny_config(tmp_path / "odd", s2d_stem=True, fuse_block1=True), device="cpu")
    assert not (t.model.backbone.s2d_stem or t.model.backbone.fuse_block1)
