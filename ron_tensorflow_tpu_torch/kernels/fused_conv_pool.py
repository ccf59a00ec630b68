"""Fused VGG block 1 (conv1_1 + ReLU + conv1_2 + ReLU + 2x2 max-pool): the
CUDA kernel and its plain version.

Port of `ron_tensorflow_tpu/kernels/fused_conv_pool.py::fused_vgg_block1`,
forward only. The kernel is `csrc/fused_vgg_block1.cu`. Its numerics are
the TPU kernel's: input and weights rounded to bf16, f32 sums and biases,
conv1_1's output rounded to bf16 before conv1_2, one bf16 rounding of the
pooled output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

CIN, C = 3, 64  # VGG block 1; the kernel is built for these widths


def fused_block1_supported(height: int, width: int) -> bool:
    """The CUDA kernel needs even spatial dims (2x2 pool windows); any tile
    remainder is masked inside the kernel."""
    return height % 2 == 0 and width % 2 == 0


def fused_vgg_block1_plain(x, w1, b1, w2, b2):
    """maxpool2(relu(conv(relu(conv(x, w1) + b1), w2) + b2)), plain PyTorch.

    x: [B, H, W, Ci] NHWC; w1: [C, Ci, 3, 3] and w2: [C, C, 3, 3] OIHW;
    b1, b2: [C] -> [B, H/2, W/2, C] in x.dtype (bf16-valued)."""
    bf16 = torch.bfloat16
    xb = x.to(bf16).float().permute(0, 3, 1, 2)
    y1 = F.relu(F.conv2d(xb, w1.to(bf16).float(), b1.float(), padding=1))
    y1 = y1.to(bf16).float()
    z = F.relu(F.conv2d(y1, w2.to(bf16).float(), b2.float(), padding=1))
    out = F.max_pool2d(z, 2, 2, ceil_mode=True).to(bf16)
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def fused_vgg_block1(x, w1, b1, w2, b2):
    """The fused block-1 kernel for a CUDA tensor, its plain version for a
    CPU tensor. Same arguments as `fused_vgg_block1_plain`; on CUDA,
    Ci = 3, C = 64, H and W even, x contiguous bf16 or f32."""
    if x.device.type == "cpu":
        return fused_vgg_block1_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda" or any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("x and the weights must lie on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != CIN or not x.is_contiguous():
        raise ValueError(f"x must be contiguous NHWC [B, H, W, {CIN}], got {tuple(x.shape)}")
    if w1.shape != (C, CIN, 3, 3) or w2.shape != (C, C, 3, 3) or b1.shape != (C,) or b2.shape != (C,):
        raise ValueError(
            f"weights must be [{C}, {CIN}, 3, 3], [{C}], [{C}, {C}, 3, 3], [{C}]; got "
            f"{tuple(w1.shape)}, {tuple(b1.shape)}, {tuple(w2.shape)}, {tuple(b2.shape)}"
        )
    batch, height, width, _ = x.shape
    if not fused_block1_supported(height, width):
        raise ValueError(f"fused block 1 needs even H and W, got {height}x{width}")
    xb = x.to(torch.bfloat16)
    w1h = w1.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()  # HWIO
    w2h = w2.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    out = torch.empty(batch, height // 2, width // 2, C, dtype=torch.bfloat16, device=x.device)
    if w2h.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("conv1_2 weights and output must be 16-byte aligned")
    with torch.cuda.device(x.device):
        err = _build.library().fused_vgg_block1(
            xb.data_ptr(), w1h.data_ptr(), b1f.data_ptr(), w2h.data_ptr(), b2f.data_ptr(),
            out.data_ptr(), batch, height, width, torch.cuda.current_stream().cuda_stream,
        )
    _build.check("fused_vgg_block1", err)
    fused_vgg_block1.launches += 1
    return out.to(x.dtype)


fused_vgg_block1.launches = 0
