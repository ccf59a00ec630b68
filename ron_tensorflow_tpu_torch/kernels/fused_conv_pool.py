"""Fused 3x3 conv + bias + ReLU + 2x2 max-pool kernels and their plain
versions.

Ports of `ron_tensorflow_tpu/kernels/fused_conv_pool.py`:

- `fused_vgg_block1`, a VGG double-conv block (conv A, Ci -> C, + ReLU +
  conv B, C -> C, + ReLU + pool), kernels `csrc/fused_vgg_block1.cu`: VGG
  block 1's (Ci = 3, C = 64) and one for every other width (block 2 is
  64 -> 128). Its numerics are the TPU kernel's: input and
  weights rounded to bf16, f32 sums and biases, conv A's output rounded
  to bf16 before conv B, one bf16 rounding of the pooled output. It is
  differentiable as the JAX custom VJP is: the backward recomputes the
  unfused composition (`block1_reference`) and differentiates that; only
  the five inputs are saved.
- `fused_stem_conv_relu_pool2` (C -> C, `csrc/conv3x3_relu_pool2.cu`'s
  stem launcher) and `fused_conv3x3_relu_pool2` (Ci -> Co, its general
  launcher; one kernel behind both) for
  maxpool2(relu(conv3x3_SAME(x, w) + b)) with x and w
  rounded to bf16 and f32 sums. The stem rounds the pooled value to bf16
  before the cast to x.dtype, as its TPU kernel's identity-matmul pool
  does (`fused_conv_pool.py:78-90`); the general one casts the f32 value
  to x.dtype only (`:466`).

Block 1's conv1_2, the stem and the general kernel run on the tensor
cores through one mainloop (`csrc/conv3x3_mma.cuh`), so on the same
conv1_1 map they give the same bits. Layouts: x NHWC, weights OIHW (the
port's `Conv.weight`), biases [Co]. The kernels take the weights as
[tap][co][ci] (`_taps_co_ci`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from .. import full_f32_convs
from . import _build

BLOCK1_CIN, BLOCK1_C = 3, 64  # the widths of the block-1 kernel (conv1_1 on the CUDA cores)


def _to_nchw_f32_bf16(x):
    """NHWC -> NCHW float32 holding bf16-rounded values."""
    return x.to(torch.bfloat16).float().permute(0, 3, 1, 2)


def _taps_co_ci(w):
    """OIHW -> [3, 3, Co, Ci] bf16, contiguous: the tensor-core kernels'
    B operand, one [Co][Ci] matrix per tap."""
    return w.permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()


def _check_cuda_args(name, x, *params):
    if x.device.type != "cuda" or any(t.device != x.device for t in params):
        raise ValueError(f"{name}: x and the weights must lie on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be bf16 or f32, got {x.dtype}")


# --------------------------------------------------------------------------- #
# Fused VGG block 1 (K-B)


def fused_block1_supported(height: int, width: int) -> bool:
    """The CUDA kernel needs even spatial dims (2x2 pool windows); any tile
    remainder is masked inside the kernel."""
    return height % 2 == 0 and width % 2 == 0


def fused_vgg_block1_plain(x, w1, b1, w2, b2):
    """maxpool2(relu(conv(relu(conv(x, w1) + b1), w2) + b2)), plain PyTorch.

    x: [B, H, W, Ci] NHWC; w1: [C, Ci, 3, 3] and w2: [C, C, 3, 3] OIHW;
    b1, b2: [C] -> [B, H/2, W/2, C] in x.dtype (bf16-valued)."""
    bf16 = torch.bfloat16
    with full_f32_convs():
        y1 = F.relu(F.conv2d(_to_nchw_f32_bf16(x), w1.to(bf16).float(), b1.float(), padding=1))
        y1 = y1.to(bf16).float()
        z = F.relu(F.conv2d(y1, w2.to(bf16).float(), b2.float(), padding=1))
    out = F.max_pool2d(z, 2, 2, ceil_mode=True).to(bf16)
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def block1_reference(x, w1, b1, w2, b2):
    """The unfused composition the block-1 kernel replaces, counterpart of
    `fused_conv_pool.py::_block1_xla_reference`: params cast to x.dtype,
    SAME 3x3 convs, + bias, ReLU, twice, then the 2x2/s2 max pool; no bf16
    rounding beyond x.dtype's own. Its gradients are the kernel's."""
    dt = x.dtype
    h = x.permute(0, 3, 1, 2)
    h = F.relu(F.conv2d(h, w1.to(dt), padding=1) + b1.to(dt)[:, None, None])
    h = F.relu(F.conv2d(h, w2.to(dt), padding=1) + b2.to(dt)[:, None, None])
    return F.max_pool2d(h, 2, 2, ceil_mode=True).permute(0, 2, 3, 1)


def _pad_block_operands(x, w1, b1, w2, b2):
    """The block's operands with zero channels appended up to the widths a
    kernel takes: Ci to 3 and C to 64 where they fit the block-1 kernel
    (Ci <= 3, C <= 64), else Ci to a multiple of 8 (a 16-byte vector of
    bf16) and C to a multiple of 64 (one chunk of the tensor-core convs).
    A copy only of what is padded. The zeros add nothing to any sum, and a
    padded channel of conv A's output is relu(0 + 0) = 0, so the first C
    channels of the output are unchanged."""
    cin, c = x.shape[-1], w1.shape[0]
    if cin <= BLOCK1_CIN and c <= BLOCK1_C:
        pci, pc = BLOCK1_CIN - cin, BLOCK1_C - c
    else:
        pci, pc = -cin % 8, -c % 64
    if pci:
        x = F.pad(x, (0, pci))
    if pci or pc:
        w1 = F.pad(w1, (0, 0, 0, 0, 0, pci, 0, pc))
    if pc:
        b1, w2, b2 = F.pad(b1, (0, pc)), F.pad(w2, (0, 0, 0, 0, 0, pc, 0, pc)), F.pad(b2, (0, pc))
    return x, w1, b1, w2, b2


SLAB_CI = 64  # input channels of one weight slab of the block-2 kernel (one 128-byte row a co)


def _block2_weight_image(w, co_width):
    """OIHW weights [Co, Ci, 3, 3] as the block-2 kernel's slab image:
    [Co / co_width, ceil(Ci / 64), 9 taps, co_width, 64] bf16, contiguous,
    Ci zero-padded to whole slabs. Slab (group, ci chunk, tap) is one
    [co][64 ci] matrix whose 16-byte chunk c (channels 8c..8c+7) of row co
    sits at chunk c ^ (co % 8): the 128-byte swizzle the kernel's wgmma
    descriptor reads (`w_offset` in csrc/conv3x3_mma.cuh), so each slab is
    one bulk copy into shared memory. Co must be a multiple of co_width."""
    co, ci = w.shape[:2]
    nci = -(-ci // SLAB_CI)
    taps = _taps_co_ci(w).reshape(9, co, ci)
    if ci % SLAB_CI:
        taps = F.pad(taps, (0, nci * SLAB_CI - ci))
    slabs = taps.reshape(9, co // co_width, co_width, nci, 8, 8).permute(1, 3, 0, 2, 4, 5)
    rows = torch.arange(co_width, device=w.device)[:, None]
    chunks = torch.arange(8, device=w.device)[None, :] ^ (rows & 7)
    return slabs[:, :, :, rows, chunks].contiguous().view(co // co_width, nci, 9, co_width, SLAB_CI)


_WEIGHT_IMAGES = WeakIdKeyDictionary()  # weight tensor -> ((its version, co_width), its slab image)


def _cached_weight_image(w, co_width):
    """`_block2_weight_image(w, co_width)`, kept beside w until w is changed
    in place (its version moves) or freed: a model's weights are laid out
    once, not at every call. An inference tensor has no version counter, so
    its image is made anew each time."""
    if w.is_inference():
        return _block2_weight_image(w, co_width)
    key = (w._version, co_width)
    hit = _WEIGHT_IMAGES.get(w)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        image = _block2_weight_image(w, co_width)
    _WEIGHT_IMAGES[w] = (key, image)
    return image


def _block1_forward(x, w1, b1, w2, b2):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return fused_vgg_block1_plain(x, w1, b1, w2, b2)
    _check_cuda_args("fused_vgg_block1", x, w1, b1, w2, b2)
    if x.dim() != 4 or w1.dim() != 4 or w1.shape[1:] != (x.shape[-1], 3, 3):
        raise ValueError(f"need x [B, H, W, Ci] and w1 [C, Ci, 3, 3], got {tuple(x.shape)}, {tuple(w1.shape)}")
    c = w1.shape[0]
    if w2.shape != (c, c, 3, 3) or b1.shape != (c,) or b2.shape != (c,):
        raise ValueError(
            f"need b1 [{c}], w2 [{c}, {c}, 3, 3], b2 [{c}]; got {tuple(b1.shape)}, {tuple(w2.shape)}, {tuple(b2.shape)}"
        )
    batch, height, width, _ = x.shape
    if not fused_block1_supported(height, width):
        raise ValueError(f"fused block 1 needs even H and W, got {height}x{width}")
    x, w1, b1, w2, b2 = _pad_block_operands(x, w1, b1, w2, b2)
    cin, cp = x.shape[-1], w1.shape[0]
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    out = torch.empty(batch, height // 2, width // 2, cp, dtype=torch.bfloat16, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        if (cin, cp) == (BLOCK1_CIN, BLOCK1_C):
            w1h = w1.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()  # HWIO
            w2h = _taps_co_ci(w2)
        else:  # the slab images at the widths of the kernel this C launches
            w1h = _cached_weight_image(w1, SLAB_CI)
            w2h = _cached_weight_image(w2, lib.fused_vgg_block2_conv_b_n(cp))
        if w2h.data_ptr() % 16 or out.data_ptr() % 16:
            raise ValueError("conv B's weights and the output must be 16-byte aligned")
        stream = torch.cuda.current_stream().cuda_stream
        if (cin, cp) == (BLOCK1_CIN, BLOCK1_C):
            err = lib.fused_vgg_block1(
                xb.data_ptr(), w1h.data_ptr(), b1f.data_ptr(), w2h.data_ptr(), b2f.data_ptr(),
                out.data_ptr(), batch, height, width, stream,
            )
        else:
            err = lib.fused_vgg_block2(
                xb.data_ptr(), w1h.data_ptr(), b1f.data_ptr(), w2h.data_ptr(), b2f.data_ptr(),
                out.data_ptr(), batch, height, width, cin, cp, stream,
            )
    _build.check("fused_vgg_block1", err)
    fused_vgg_block1.launches += 1
    if cp != c:
        out = out[..., :c].contiguous()
    return out.to(x.dtype)


class _FusedBlock1(torch.autograd.Function):
    """Forward through the kernel (or its plain version); backward by
    recomputing `block1_reference` from the saved inputs, as the JAX custom
    VJP does (`fused_conv_pool.py:366-385`): no block-1 activation is kept
    between the two passes."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _block1_forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = block1_reference(*inputs)
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_vgg_block1(x, w1, b1, w2, b2):
    """The fused VGG block kernel for a CUDA tensor, its plain version for
    a CPU tensor. Same arguments as `fused_vgg_block1_plain`; on CUDA, any
    Ci and C, H and W even, x bf16 or f32, one launch: the block-1 kernel
    where Ci <= 3 and C <= 64 (VGG block 1), the tensor-core one for every
    other width (VGG block 2, 64 -> 128), each on operands with zero
    channels appended up to its widths (`_pad_block_operands`) and the
    output cut back to C channels.

    Differentiable (recompute backward, see `_FusedBlock1`). When no input
    needs a gradient, or under `torch.no_grad()`/`torch.inference_mode()`,
    it calls the forward directly: nothing is saved."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _FusedBlock1.apply(x, w1, b1, w2, b2)
    return _block1_forward(x, w1, b1, w2, b2)


fused_vgg_block1.launches = 0


# --------------------------------------------------------------------------- #
# conv3x3 + ReLU + 2x2 pool (K-D stem, K-E general)


def _conv_relu_pool_f32(x, w, b):
    """maxpool2(relu(conv3x3_SAME(bf16(x), bf16(w)) + b)) in f32, NHWC."""
    with full_f32_convs():
        z = F.conv2d(_to_nchw_f32_bf16(x), w.to(torch.bfloat16).float(), padding=1)
    z = F.relu(z + b.float()[:, None, None])
    return F.max_pool2d(z, 2, 2).permute(0, 2, 3, 1).contiguous()


def _check_conv_shapes(name, x, w, b, same_channels):
    if x.dim() != 4 or w.dim() != 4 or w.shape[2:] != (3, 3) or w.shape[1] != x.shape[-1]:
        raise ValueError(f"{name}: need x [B, H, W, Ci] and w [Co, Ci, 3, 3], got {tuple(x.shape)}, {tuple(w.shape)}")
    if b.shape != (w.shape[0],):
        raise ValueError(f"{name}: need b [{w.shape[0]}], got {tuple(b.shape)}")
    if same_channels and w.shape[0] != w.shape[1]:
        raise ValueError(f"{name}: the stem kernel needs C = Co, got {w.shape[1]} -> {w.shape[0]}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{name}: even spatial dims required, got {x.shape[1]}x{x.shape[2]}")


def fused_stem_conv_relu_pool2_plain(x, w, b):
    """K-D's function in plain PyTorch: x [B, H, W, C], w [C, C, 3, 3] OIHW,
    b [C] -> [B, H/2, W/2, C], the pooled value rounded to bf16, then cast
    to x.dtype."""
    _check_conv_shapes("fused_stem_conv_relu_pool2", x, w, b, same_channels=True)
    return _conv_relu_pool_f32(x, w, b).to(torch.bfloat16).to(x.dtype)


def fused_conv3x3_relu_pool2_plain(x, w, b):
    """K-E's function in plain PyTorch: x [B, H, W, Ci], w [Co, Ci, 3, 3]
    OIHW, b [Co] -> [B, H/2, W/2, Co], the f32 value cast to x.dtype."""
    _check_conv_shapes("fused_conv3x3_relu_pool2", x, w, b, same_channels=False)
    return _conv_relu_pool_f32(x, w, b).to(x.dtype)


def _pad_input_channels(x, w):
    """x [B, H, W, Ci] and w [Co, Ci, 3, 3] with their input channels
    zero-padded up to a multiple of 8, the kernel's 16-byte vector of bf16.
    A copy, made only where Ci is not such a multiple; the zeros add nothing
    to any sum, so the function is unchanged."""
    pad = -x.shape[-1] % 8
    if pad == 0:
        return x, w
    return F.pad(x, (0, pad)), F.pad(w, (0, 0, 0, 0, 0, pad))


def _pad_output_channels(w, b):
    """w [Co, Ci, 3, 3] and b [Co] with zero output channels appended up to
    a multiple of 8, the kernel's 16-byte vector store of bf16. A copy,
    made only where Co is not such a multiple; each output channel is its
    own sum, so the first Co channels of the output are unchanged."""
    pad = -w.shape[0] % 8
    if pad == 0:
        return w, b
    return F.pad(w, (0, 0, 0, 0, 0, 0, 0, pad)), F.pad(b, (0, pad))


def _conv_kernel_args(x, w, b):
    """The kernel's operands, in plain PyTorch: x as contiguous bf16 NHWC
    with Ci padded to a multiple of 8 and 16-byte aligned (a misaligned
    view is copied: `.contiguous()` keeps its offset), the weights as
    [9 taps, Co, Ci] bf16 (`_taps_co_ci`) with Co padded to a multiple of 8
    too, and the bias as f32."""
    x, w = _pad_input_channels(x, w)
    w, b = _pad_output_channels(w, b)
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    return xb, _taps_co_ci(w).reshape(9, w.shape[0], w.shape[1]), b.float().contiguous()


def _launch_conv_relu_pool(name, x, w, b, out_bf16):
    """Run `csrc/conv3x3_relu_pool2.cu`'s tensor-core kernel: the stem's
    launcher or the general one (`name`); bf16 out when out_bf16, else
    f32. Returns the output in x.dtype, cut back to Co channels where they
    were padded."""
    _check_cuda_args(name, x, w, b)
    batch, height, width, _ = x.shape
    cout = w.shape[0]
    xb, wt, bf = _conv_kernel_args(x, w, b)
    cout_k = wt.shape[1]
    out = torch.empty(
        batch, height // 2, width // 2, cout_k,
        dtype=torch.bfloat16 if out_bf16 else torch.float32, device=x.device,
    )
    if wt.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{name}: weights and output must be 16-byte aligned")
    args = [xb.data_ptr(), wt.data_ptr(), bf.data_ptr(), out.data_ptr(), batch, height, width, xb.shape[-1], cout_k]
    if name == "fused_conv3x3_relu_pool2":
        args.append(int(out_bf16))  # the general launcher stores f32 for an f32 x
    with torch.cuda.device(x.device):
        err = getattr(_build.library(), name)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(name, err)
    if cout_k != cout:
        out = out[..., :cout].contiguous()
    return out.to(x.dtype)


def fused_stem_conv_relu_pool2(x, w, b):
    """K-D, `maxpool2(relu(conv3x3_SAME(x, w) + b))` with C = Co: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor. Same
    arguments as `fused_stem_conv_relu_pool2_plain`; on CUDA, any C, x bf16
    or f32. The output is bf16-valued whatever x.dtype. Where C is not a
    multiple of 8, the kernel runs on operands with zero channels appended
    (`_conv_kernel_args`)."""
    if x.device.type == "cpu":
        return fused_stem_conv_relu_pool2_plain(x, w, b)
    _check_conv_shapes("fused_stem_conv_relu_pool2", x, w, b, same_channels=True)
    out = _launch_conv_relu_pool("fused_stem_conv_relu_pool2", x, w, b, out_bf16=True)
    fused_stem_conv_relu_pool2.launches += 1
    return out


def fused_conv3x3_relu_pool2(x, w, b):
    """K-E, `maxpool2(relu(conv3x3_SAME(x, w) + b))`, Ci -> Co: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor. Same
    arguments as `fused_conv3x3_relu_pool2_plain`; on CUDA, any Ci and Co,
    x bf16 or f32. An f32 x gives an f32 result, not rounded to bf16.
    Where Ci or Co is not a multiple of 8, x and w are first copied with
    zero channels appended (`_pad_input_channels`, `_pad_output_channels`)
    and the output is cut back to Co channels; the kernel runs all the
    same."""
    if x.device.type == "cpu":
        return fused_conv3x3_relu_pool2_plain(x, w, b)
    _check_conv_shapes("fused_conv3x3_relu_pool2", x, w, b, same_channels=False)
    out = _launch_conv_relu_pool("fused_conv3x3_relu_pool2", x, w, b, out_bf16=x.dtype == torch.bfloat16)
    fused_conv3x3_relu_pool2.launches += 1
    return out


fused_stem_conv_relu_pool2.launches = 0
fused_conv3x3_relu_pool2.launches = 0
