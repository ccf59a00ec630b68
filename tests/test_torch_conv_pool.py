"""The port's fused conv3x3 + ReLU + 2x2-pool plain versions (K-D stem,
K-E general) against the JAX package's Pallas kernels in interpret mode,
on the CPU. The CUDA kernel is held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: both sides round x and w to bf16 and sum in f32, in another
order. An f32 output may differ by f32 rounding of a sum of a few hundred
terms: within 1e-4 * (1 + |ref|). A bf16-rounded output may land one bf16
ulp apart, when the two f32 sums straddle a rounding boundary: within
ulp(ref) = 2^(floor(log2 |ref|) - 7), between 2^-8 and 2^-7 of |ref|,
plus 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.kernels import fused_conv3x3_relu_pool2 as jax_general
from ron_tensorflow_tpu.kernels import fused_stem_conv_relu_pool2 as jax_stem

from ron_tensorflow_tpu_torch import kernels
from ron_tensorflow_tpu_torch.kernels import fused_conv_pool as fcp
from ron_tensorflow_tpu_torch.kernels import (
    fused_conv3x3_relu_pool2,
    fused_conv3x3_relu_pool2_plain,
    fused_stem_conv_relu_pool2,
    fused_stem_conv_relu_pool2_plain,
)


def oihw(w_hwio):
    """HWIO -> OIHW, the transpose of `ron_tensorflow_tpu_torch/weights.py`."""
    return torch.as_tensor(np.asarray(w_hwio)).permute(3, 2, 0, 1).contiguous()


def conv_inputs(seed, shape, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, w, b


def bf16_ulp(ref):
    """One bf16 ulp of each (bf16-valued) reference entry,
    2^(floor(log2 |ref|) - 7) with the exponent from frexp; 0 at 0."""
    ref = np.asarray(ref, np.float64)
    _, e = np.frexp(ref)
    return np.where(ref != 0, np.ldexp(1.0, e - 8), 0.0)


def assert_within_one_bf16_ulp(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    bad = np.abs(got - ref) > bf16_ulp(ref) + 1e-6
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} outputs more than one bf16 ulp apart"


def assert_f32_close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_less(np.abs(got - ref), 1e-4 * (1 + np.abs(ref)) + 1e-30)


def run_both(jax_fn, plain_fn, args, dtype):
    x, w, b = args
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    ref = np.asarray(jax_fn(jx, jnp.asarray(w), jnp.asarray(b), interpret=True).astype(jnp.float32))
    got = plain_fn(torch.as_tensor(x).to(dtype), oihw(w), torch.as_tensor(b))
    assert got.dtype == dtype
    return got.float().numpy(), ref


DTYPES = [torch.float32, torch.bfloat16]

# (shape [B, H, W], C): the shape of tests/test_fused_conv_pool.py, and one
# of 64 rows that spans several of the stem kernel's 32-row tiles.
STEM_CASES = [((2, 16, 16), 8), ((1, 64, 8), 8)]
# (shape, Ci, Co): the shapes of tests/test_fused_conv_pool.py (square and
# rectangular channels), and one of 128 rows: two 64-row tiles.
GENERAL_CASES = [((2, 16, 16), 8, 8), ((1, 8, 8), 4, 16), ((1, 128, 8), 8, 8)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,c", STEM_CASES)
def test_stem_plain_matches_pallas_interpret(shape, c, dtype):
    """The stem always rounds its output to bf16: within one bf16 ulp."""
    got, ref = run_both(jax_stem, fused_stem_conv_relu_pool2_plain, conv_inputs(0, shape, c, c), dtype)
    assert got.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, c)
    assert_within_one_bf16_ulp(got, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,cin,cout", GENERAL_CASES)
def test_general_plain_matches_pallas_interpret(shape, cin, cout, dtype):
    """f32 x gives an f32 output (1e-4 * (1 + |ref|)); bf16 x one rounding
    to bf16 (one bf16 ulp)."""
    got, ref = run_both(jax_general, fused_conv3x3_relu_pool2_plain, conv_inputs(1, shape, cin, cout), dtype)
    assert got.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, cout)
    if dtype == torch.float32:
        assert_f32_close(got, ref)
    else:
        assert_within_one_bf16_ulp(got, ref)


def test_rounding_differs_between_stem_and_general():
    """For f32 x, the stem's output equals its own bf16 round trip and the
    general kernel's does not: the TPU kernels differ just there, and the
    port keeps that."""
    x, w, b = conv_inputs(2, (2, 16, 16), 8, 8)
    args = (torch.as_tensor(x), oihw(w), torch.as_tensor(b))
    stem = fused_stem_conv_relu_pool2_plain(*args)
    general = fused_conv3x3_relu_pool2_plain(*args)
    assert stem.dtype == general.dtype == torch.float32
    torch.testing.assert_close(stem, stem.to(torch.bfloat16).float(), rtol=0, atol=0)
    assert not torch.equal(general, general.to(torch.bfloat16).float())
    torch.testing.assert_close(stem, general.to(torch.bfloat16).float(), rtol=0, atol=0)
    # the same on the TPU kernels themselves
    jargs = tuple(map(jnp.asarray, (x, w, b)))
    jstem = np.asarray(jax_stem(*jargs, interpret=True))
    jgeneral = np.asarray(jax_general(*jargs, interpret=True))
    np.testing.assert_array_equal(jstem, np.asarray(jnp.asarray(jstem).astype(jnp.bfloat16).astype(jnp.float32)))
    assert not np.array_equal(jgeneral, np.asarray(jnp.asarray(jgeneral).astype(jnp.bfloat16).astype(jnp.float32)))


def test_wrappers_run_plain_on_cpu_without_counting():
    x, w, b = conv_inputs(3, (1, 8, 12), 8, 8)
    args = (torch.as_tensor(x), oihw(w), torch.as_tensor(b))
    kernels.reset_launch_counts()
    torch.testing.assert_close(fused_stem_conv_relu_pool2(*args), fused_stem_conv_relu_pool2_plain(*args), rtol=0, atol=0)
    torch.testing.assert_close(fused_conv3x3_relu_pool2(*args), fused_conv3x3_relu_pool2_plain(*args), rtol=0, atol=0)
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize(
    "fn", [fused_stem_conv_relu_pool2_plain, fused_conv3x3_relu_pool2_plain], ids=["stem", "general"]
)
def test_plain_versions_reject_odd_spatial_dims(fn):
    x, w, b = conv_inputs(4, (1, 7, 8), 8, 8)
    with pytest.raises(ValueError):
        fn(torch.as_tensor(x), oihw(w), torch.as_tensor(b))


def test_stem_rejects_channel_change():
    x, w, b = conv_inputs(5, (1, 8, 8), 4, 16)
    with pytest.raises(ValueError):
        fused_stem_conv_relu_pool2_plain(torch.as_tensor(x), oihw(w), torch.as_tensor(b))
    out = fused_conv3x3_relu_pool2_plain(torch.as_tensor(x), oihw(w), torch.as_tensor(b))
    assert out.shape == (1, 4, 4, 16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin", [4, 12])
def test_channel_padding_leaves_the_function_unchanged(cin, dtype):
    """The kernel's wrapper pads Ci up to a multiple of 8 with zeros; the
    padded operands give the plain version's output bit for bit."""
    x, w, b = conv_inputs(6, (2, 8, 12), cin, 16)
    x, w, b = torch.as_tensor(x).to(dtype), oihw(w), torch.as_tensor(b)
    xp, wp = fcp._pad_input_channels(x, w)
    assert xp.shape[-1] == wp.shape[1] == 8 * -(-cin // 8)
    assert not xp[..., cin:].any() and not wp[:, cin:].any()
    torch.testing.assert_close(fused_conv3x3_relu_pool2_plain(xp, wp, b),
                               fused_conv3x3_relu_pool2_plain(x, w, b), rtol=0, atol=0)


def test_taps_co_ci_indexes_like_hwio():
    """The kernels' [tap][co][ci] weights, here for Ci != Co (24 -> 40):
    tap t = 3 dy + dx holds HWIO[dy, dx, ci, co] rounded to bf16."""
    _, w_hwio, b = conv_inputs(7, (1, 2, 2), 24, 40)
    packed = fcp._conv_kernel_args(torch.zeros(1, 2, 2, 24), oihw(w_hwio), torch.as_tensor(b))[1]
    assert packed.shape == (9, 40, 24) and packed.dtype == torch.bfloat16 and packed.is_contiguous()
    ref = torch.as_tensor(w_hwio).to(torch.bfloat16)
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(packed[3 * dy + dx], ref[dy, dx].T)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_args_copy_a_misaligned_view(dtype):
    """x that starts one element past a 16-byte boundary is copied to an
    aligned bf16 tensor with the same values; an aligned bf16 x is passed
    as it is."""
    x, w, b = conv_inputs(8, (1, 4, 6), 8, 8)
    base = torch.as_tensor(x).to(dtype).flatten()
    view = torch.cat([base[:1], base])[1:].view(1, 4, 6, 8)  # contiguous, misaligned
    assert view.is_contiguous() and view.data_ptr() % 16
    xb, _, bf = fcp._conv_kernel_args(view, oihw(w), torch.as_tensor(b))
    assert xb.data_ptr() % 16 == 0 and xb.dtype == torch.bfloat16 and bf.dtype == torch.float32
    assert torch.equal(xb, view.to(torch.bfloat16))
    aligned = view.to(torch.bfloat16).clone()
    assert fcp._conv_kernel_args(aligned, oihw(w), torch.as_tensor(b))[0] is aligned


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cout", [5, 12])
def test_output_channel_padding_leaves_the_function_unchanged(cout, dtype):
    """The kernel's wrapper pads Co up to a multiple of 8 with zero weights
    and biases (for the stem, Ci alike); the plain versions' first Co
    output channels on the padded operands are their output on the
    originals bit for bit, and the padded channels are relu(0) = 0."""
    x, w, b = conv_inputs(9, (2, 8, 12), 16, cout)
    x, w, b = torch.as_tensor(x).to(dtype), oihw(w), torch.as_tensor(b)
    wp, bp = fcp._pad_output_channels(w, b)
    assert wp.shape == (8 * -(-cout // 8), 16, 3, 3) and bp.shape == (wp.shape[0],)
    assert not wp[cout:].any() and not bp[cout:].any()
    padded = fused_conv3x3_relu_pool2_plain(x, wp, bp)
    assert not padded[..., cout:].any()
    torch.testing.assert_close(padded[..., :cout], fused_conv3x3_relu_pool2_plain(x, w, b), rtol=0, atol=0)
    assert fcp._conv_kernel_args(x, w, b)[1].shape == (9, wp.shape[0], 16)

    xs, ws, bs = conv_inputs(10, (2, 8, 12), cout, cout)
    xs, ws, bs = torch.as_tensor(xs).to(dtype), oihw(ws), torch.as_tensor(bs)
    xsp, wsp = fcp._pad_input_channels(xs, ws)
    wsp, bsp = fcp._pad_output_channels(wsp, bs)
    assert wsp.shape[0] == wsp.shape[1] == xsp.shape[-1] == 8 * -(-cout // 8)
    torch.testing.assert_close(fused_stem_conv_relu_pool2_plain(xsp, wsp, bsp)[..., :cout],
                               fused_stem_conv_relu_pool2_plain(xs, ws, bs), rtol=0, atol=0)
