"""K-B at widths other than VGG block 1's, on the CPU: the port's plain
`fused_vgg_block1_plain` against the JAX package's Pallas kernel in
interpret mode at VGG block 2's widths (64 -> 128), and the zero channels
the CUDA wrapper appends before a launch (`_pad_block_operands`), held to
change nothing. The CUDA kernels themselves are held against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.kernels import fused_vgg_block1 as jax_fused_vgg_block1

from ron_tensorflow_tpu_torch import kernels
from ron_tensorflow_tpu_torch.kernels import fused_conv_pool as fcp
from ron_tensorflow_tpu_torch.kernels import fused_vgg_block1, fused_vgg_block1_plain


def oihw(w_hwio):
    return torch.as_tensor(np.asarray(w_hwio)).permute(3, 2, 0, 1).contiguous()


def block_inputs(seed, shape, cin, c):
    """Activations at post-ReLU scale and He-scaled HWIO weights, numpy."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(*shape, cin)) * 3, 0).astype(np.float32)
    w1 = (rng.normal(size=(3, 3, cin, c)) * (2 / (9 * cin)) ** 0.5).astype(np.float32)
    b1 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, c, c)) * (2 / (9 * c)) ** 0.5).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def torch_args(x, w1, b1, w2, b2, dtype=torch.float32):
    return torch.as_tensor(x).to(dtype), oihw(w1), torch.as_tensor(b1), oihw(w2), torch.as_tensor(b2)


# (1, 16, 16) is one row tile of the TPU kernel (16 rows); (1, 64, 8) spans
# two of its 32-row tiles, so the halo between them is read.
@pytest.mark.parametrize("shape", [(1, 16, 16), (1, 64, 8)])
def test_block2_plain_matches_pallas_interpret(shape):
    """The tolerance of `test_block1_plain_matches_pallas_interpret`: the
    two sum in another order, so a value may cross a bf16 rounding
    boundary, in conv A's output or in the pooled one."""
    args = block_inputs(5, shape, 64, 128)
    ref = np.asarray(jax_fused_vgg_block1(*map(jnp.asarray, args), interpret=True))
    got = fused_vgg_block1_plain(*torch_args(*args)).numpy()
    assert got.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, 128)
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,c", [(3, 8), (8, 8), (64, 128), (5, 72)])
def test_block_padding_leaves_the_function_unchanged(cin, c, dtype):
    """The operands the CUDA wrapper launches with: Ci and C padded with
    zeros to the kernel's widths (3 and 64 for block 1's kernel, else
    multiples of 8 and 64). The plain version on them, cut back to C
    channels, gives the plain version's output on the originals bit for
    bit."""
    x, w1, b1, w2, b2 = torch_args(*block_inputs(6, (2, 12, 20), cin, c), dtype=dtype)
    xp, w1p, b1p, w2p, b2p = fcp._pad_block_operands(x, w1, b1, w2, b2)
    block1 = cin <= 3 and c <= 64
    want_ci, want_c = (3, 64) if block1 else (8 * -(-cin // 8), 64 * -(-c // 64))
    assert xp.shape[-1] == w1p.shape[1] == want_ci and w1p.shape[0] == w2p.shape[0] == w2p.shape[1] == want_c
    assert b1p.shape == b2p.shape == (want_c,) and xp.dtype == dtype
    assert not xp[..., cin:].any() and not w1p[:, cin:].any() and not w1p[c:].any()
    assert not w2p[c:].any() and not w2p[:, c:].any() and not b1p[c:].any() and not b2p[c:].any()
    if (want_ci, want_c) == (cin, c):
        assert xp is x and w1p is w1 and w2p is w2  # nothing to pad: no copy
    padded = fused_vgg_block1_plain(xp, w1p, b1p, w2p, b2p)
    assert padded.shape[-1] == want_c and not padded[..., c:].any()
    torch.testing.assert_close(padded[..., :c], fused_vgg_block1_plain(x, w1, b1, w2, b2), rtol=0, atol=0)


def test_block2_wrapper_runs_plain_on_cpu_without_counting():
    args = torch_args(*block_inputs(7, (1, 8, 12), 64, 128), dtype=torch.bfloat16)
    kernels.reset_launch_counts()
    out = fused_vgg_block1(*args)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 6, 128)
    torch.testing.assert_close(out, fused_vgg_block1_plain(*args), rtol=0, atol=0)
    assert kernels.fused_vgg_block1.launches == 0
