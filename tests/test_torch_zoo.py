"""The port's backbone zoo (`models/zoo.py`), the VGG classifiers and the
layers they need, against the JAX package's on the CPU: the same
numpy-made weights and BatchNorm statistics (`seeded_flax_params`, the
means N(0, 0.5) so that a mean/variance swap shows) and inputs on both
sides, in eval and train mode, in float32 and bf16.

Tolerances:
- float32 (JAX under `default_matmul_precision("highest")`): summation
  order only, within 1e-4 of each output's largest magnitude (as
  `test_torch_heavy.py`), and so each update of a BatchNorm's running
  statistics in train mode (new - old);
- bf16: both sides round every layer to bf16 but at different places
  (XLA's CPU convolutions against PyTorch's), within 5e-2 of JAX's bf16
  output's largest magnitude (as `test_torch_bf16_parity.py`), and so the
  statistics' updates; a wrong weight, tap, pad or branch order moves
  outputs by tens of percent;
- the pools: max pools exactly; averages within 1e-6 (float32: summation
  order) and 2^-6 (bf16: XLA rounds each partial sum of the window to
  bf16, torch rounds the total once) of the input's largest magnitude.

The whole networks, the VGG classifiers and the loading of JAX's init are
in `test_torch_zoo_nets.py`.
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.models import zoo as jzoo
from ron_tensorflow_tpu.train.checkpoint import flatten_params, unflatten_params

from ron_tensorflow_tpu_torch.models import layers, zoo
from ron_tensorflow_tpu_torch.models.testing import seeded_flax_params
from ron_tensorflow_tpu_torch.weights import from_jax_params, jax_names

F32_TOL = 1e-4
BF16_TOL = 5e-2
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_shapes(jmodel, x, **kw):
    """Flat {path: shape} of the JAX module's params and batch stats."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros(x.shape, jnp.float32), **kw))
    return ({k: v.shape for k, v in flatten_params(shapes["params"]).items()},
            {k: v.shape for k, v in flatten_params(shapes.get("batch_stats", {})).items()})


def load_both(model, jmodel, x, seed, **kw):
    """Seeded flax-named weights into the port's module (strict) and as JAX
    variables (the batch statistics also as numpy under "stats"); their
    names and shapes equal JAX's own init's."""
    params, stats = seeded_flax_params(model, seed, gain=np.sqrt(2.0), bn_mean_std=0.5)
    jp, js = jax_shapes(jmodel, x, **kw)
    assert {k: v.shape for k, v in params.items()} == jp
    assert {k: v.shape for k, v in stats.items()} == js
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    jvars = {"params": jax.tree.map(jnp.asarray, unflatten_params(params))}
    if stats:
        jvars["batch_stats"] = jax.tree.map(jnp.asarray, unflatten_params(stats))
    return jvars, stats


def close(got, ref, tol, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(ref).all() and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-6), err_msg=what)


def nchw(x):
    return torch.as_tensor(np.asarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def check_stats(model, old_stats, new_stats, tol, what):
    """The port module's running statistics after a train-mode forward
    against JAX's updated `batch_stats`: each update (new - old, 0.003
    times the batch statistic's distance from the running one) within `tol`
    of its largest magnitude, plus four float32 roundings of the stored
    statistic."""
    names = jax_names(model)
    want = flatten_params(new_stats)
    got = {names[n]: b for n, b in model.named_buffers()}
    assert got.keys() == want.keys() == old_stats.keys()
    for k, v in want.items():
        old, v = old_stats[k], np.asarray(v)
        rounding = 4 * np.finfo(np.float32).eps * float(np.abs(v).max())  # of the stored statistic
        np.testing.assert_allclose(got[k].numpy() - old, v - old, rtol=0,
                                   atol=tol * float(np.abs(v - old).max()) + rounding, err_msg=f"{what}: {k} update")


# --------------------------------------------------------------------------
# the pools and the dense layer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("side", [8, 9], ids=["even", "odd"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["max", "avg_include_pad", "avg_exclude_pad"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_same_pools_match_flax(side, stride, kind, dt):
    """XLA's 'SAME' pools at stride 2 on an even side pad (0, 1); the port's
    pools must pad there too (`F.max_pool2d(padding=1)` would pad (1, 1)
    and shift every window)."""
    tdt, jdt = DTYPES[dt]
    x = np.random.default_rng(side * 10 + stride).normal(0, 1, (2, side, side + 1, 3)).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    if kind == "max":
        ref = fnn.max_pool(jx, (3, 3), (stride, stride), "SAME")
        got = layers.max_pool(nchw(x).to(tdt), (3, 3), (stride, stride), "SAME")
    else:
        inc = kind == "avg_include_pad"
        ref = fnn.avg_pool(jx, (3, 3), (stride, stride), "SAME", count_include_pad=inc)
        got = layers.avg_pool(nchw(x).to(tdt), (3, 3), (stride, stride), "SAME", count_include_pad=inc)
    assert got.dtype == tdt
    ref = np.asarray(ref, np.float32)
    assert got.shape == (2, 3, *ref.shape[1:3])
    if kind == "max":
        np.testing.assert_array_equal(nhwc(got), ref)
    else:  # bf16: XLA rounds each of the window's partial sums, torch the total once
        atol = (1e-6 if dt == "f32" else 2.0 ** -6) * float(np.abs(x).max())
        np.testing.assert_allclose(nhwc(got), ref, rtol=0, atol=atol)


def test_even_side_max_pool_differs_from_symmetric_padding():
    """The case the port's pool exists for: F.max_pool2d's symmetric pad
    gives the same shape and other values."""
    x = torch.arange(2 * 3 * 8 * 8, dtype=torch.float32).reshape(2, 3, 8, 8).sin()
    same = layers.max_pool(x, (3, 3), (2, 2), "SAME")
    sym = torch.nn.functional.max_pool2d(x, 3, 2, padding=1)
    assert same.shape == sym.shape and not torch.equal(same, sym)
    ref = fnn.max_pool(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), (3, 3), (2, 2), "SAME")
    np.testing.assert_array_equal(nhwc(same), np.asarray(ref))


@pytest.mark.parametrize("shape", [(7, 3), (1, 5), (5, 1), (5, 5), (1, 3), (3, 1)], ids=str)
def test_asymmetric_kernels_pad_as_xla(shape):
    """ConvBN's asymmetric kernels (1x7, 7x1, 1x3, 3x1, 5x5) through
    `_same_pads` equal flax's SAME conv, at stride 1 and 2 on odd and even sides."""
    for stride, side in ((1, 9), (2, 8), (2, 9)):
        x = np.random.default_rng(side).normal(0, 1, (1, side, side, 4)).astype(np.float32)
        jm = jzoo.ConvBN(6, shape, strides=(stride, stride))
        m = zoo.ConvBN(4, 6, shape, (stride, stride))
        jv, _ = load_both(m, jm, x, seed=side)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(jm.apply)(jv, jnp.asarray(x))
        with torch.no_grad():
            close(nhwc(m(nchw(x))), ref, F32_TOL, f"{shape} stride {stride} side {side}")


@pytest.mark.parametrize("kernel_init", ["lecun_normal", "glorot_uniform"])
def test_dense_matches_flax(kernel_init):
    """`Dense` against flax `nn.Dense` (f32 and bf16 compute), and
    `init_like_flax_`'s draws: glorot within its limit, lecun-normal
    truncated at two deviations, each with flax's variance (+-10%)."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4, 300)).astype(np.float32)
    m = layers.Dense(300, 200, kernel_init=kernel_init)
    params, _ = seeded_flax_params(torch.nn.ModuleDict({"d": m}), 5)
    kernel, bias = params["d/kernel"], params["d/bias"]
    assert kernel.shape == (300, 200)
    m.load_state_dict(from_jax_params({"kernel": kernel, "bias": bias}, {}), strict=True)
    for dt in ("f32", "bf16"):
        tdt, jdt = DTYPES[dt]
        ref = fnn.Dense(200, dtype=jdt, param_dtype=jnp.float32).apply(
            {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x, jdt))
        with torch.no_grad():
            got = m(torch.as_tensor(x).to(tdt))
        assert got.dtype == tdt
        close(got, ref, F32_TOL if dt == "f32" else BF16_TOL, dt)
    layers.init_like_flax_(m, torch.Generator().manual_seed(0))
    w = m.weight.detach()
    if kernel_init == "glorot_uniform":
        limit = np.sqrt(6.0 / 500)
        assert float(w.abs().max()) <= limit and abs(float(w.var()) - limit ** 2 / 3) < 0.1 * limit ** 2 / 3
    else:
        assert float(w.abs().max()) <= 2.0 / np.sqrt(300) / 0.87962566103423978 + 1e-6
        assert abs(float(w.var()) - 1.0 / 300) < 0.1 / 300
    assert float(m.bias.detach().abs().max()) == 0.0


def test_depthwise_kernel_layout():
    """flax's depthwise kernel [kh, kw, 1, C] is [C, 1, kh, kw] under the
    4-D rule, in a conv with groups = C."""
    m = zoo.SeparableConvBN(5, 7)
    assert m.depthwise.groups == 5 and m.depthwise.weight.shape == (5, 1, 3, 3)
    params, _ = seeded_flax_params(m, 0)
    assert params["depthwise/kernel"].shape == (3, 3, 1, 5) and params["pointwise/kernel"].shape == (1, 1, 5, 7)
    state = from_jax_params(params, {})
    np.testing.assert_array_equal(state["depthwise.weight"][2, 0].numpy(), params["depthwise/kernel"][:, :, 0, 2])


def test_init_like_flax_bare_convs():
    """The zoo's bare convs (flax `nn.Conv` defaults): lecun-normal with
    fan in kh * kw * in per group, zero bias."""
    m = zoo.XceptionBlock(64, 128)
    layers.init_like_flax_(m, torch.Generator().manual_seed(0))
    dw, sc = m.sep1.depthwise.weight.detach(), m.shortcut.weight.detach()
    for w, fan_in in ((dw, 9), (sc, 64)):
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * std + 1e-6
        assert abs(float(w.var()) - 1.0 / fan_in) < 0.15 / fan_in
    up = zoo.InceptionResnetBlock("block35", 16).up
    layers.init_like_flax_(up)
    assert float(up.bias.detach().abs().max()) == 0.0


# --------------------------------------------------------------------------
# every block alone
# --------------------------------------------------------------------------


BLOCKS = {
    # name: (port module, JAX module, NHWC input shape)
    "InceptionA": (lambda: zoo.InceptionA(16, 8), lambda t, d: jzoo.InceptionA(8, t, d), (2, 9, 9, 16)),
    "InceptionB": (lambda: zoo.InceptionB(16), lambda t, d: jzoo.InceptionB(t, d), (2, 9, 9, 16)),
    "InceptionC": (lambda: zoo.InceptionC(16, 12), lambda t, d: jzoo.InceptionC(12, t, d), (2, 8, 8, 16)),
    "InceptionD": (lambda: zoo.InceptionD(16), lambda t, d: jzoo.InceptionD(t, d), (2, 9, 9, 16)),
    "InceptionE": (lambda: zoo.InceptionE(16), lambda t, d: jzoo.InceptionE(t, d), (2, 6, 6, 16)),
    "SeparableConvBN": (lambda: zoo.SeparableConvBN(16, 24), lambda t, d: jzoo.SeparableConvBN(24, train=t, dtype=d),
                        (2, 9, 9, 16)),
    "XceptionBlock": (lambda: zoo.XceptionBlock(16, 24), lambda t, d: jzoo.XceptionBlock(24, train=t, dtype=d),
                      (2, 8, 8, 16)),
    "XceptionBlock_no_relu_first": (lambda: zoo.XceptionBlock(16, 24, relu_first=False),
                                    lambda t, d: jzoo.XceptionBlock(24, relu_first=False, train=t, dtype=d),
                                    (2, 9, 9, 16)),
    "XceptionBlock_stride1": (lambda: zoo.XceptionBlock(16, 24, strides=(1, 1)),
                              lambda t, d: jzoo.XceptionBlock(24, strides=(1, 1), train=t, dtype=d), (2, 8, 8, 16)),
    "block35": (lambda: zoo.InceptionResnetBlock("block35", 24, 0.17),
                lambda t, d: jzoo.InceptionResnetBlock("block35", 0.17, t, d), (2, 7, 7, 24)),
    "block17": (lambda: zoo.InceptionResnetBlock("block17", 24, 0.10),
                lambda t, d: jzoo.InceptionResnetBlock("block17", 0.10, t, d), (2, 8, 8, 24)),
    "block8": (lambda: zoo.InceptionResnetBlock("block8", 24, 0.20),
               lambda t, d: jzoo.InceptionResnetBlock("block8", 0.20, t, d), (2, 5, 5, 24)),
    "block8_final": (lambda: zoo.InceptionResnetBlock("block8", 24, 1.0, activation=False),
                     lambda t, d: jzoo.InceptionResnetBlock("block8", 1.0, t, d, activation=False), (2, 5, 5, 24)),
}


def run_block(name, dt, train):
    make, jmake, shape = BLOCKS[name]
    tdt, jdt = DTYPES[dt]
    x = np.random.default_rng(len(name)).normal(0, 1, shape).astype(np.float32)
    m, jm = make(), jmake(train, jdt)
    jv, stats = load_both(m, jm, x, seed=7)
    jx = jnp.asarray(x, jdt)
    with jax.default_matmul_precision("highest"):
        if train:
            ref, new_vars = jax.jit(lambda v, a: jm.apply(v, a, mutable=["batch_stats"]))(jv, jx)
        else:
            ref = jax.jit(jm.apply)(jv, jx)
    with torch.no_grad():
        got = m(nchw(x).to(tdt), train=train)
    assert got.dtype == tdt and np.asarray(ref).dtype == jdt
    tol = F32_TOL if dt == "f32" else BF16_TOL
    close(nhwc(got), ref, tol, f"{name} {dt} train={train}")
    if train:
        check_stats(m, stats, new_vars["batch_stats"], tol, name)
    return m


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name, dt, train):
    run_block(name, dt, train)


def test_activation_false_keeps_negatives():
    m = run_block("block8_final", "f32", False)
    x = torch.randn(1, 24, 5, 5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert float(m(x).min()) < 0.0
