"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a CUDA device every test here skips. This file
imports torch and the port only, so it runs on a GPU host without JAX:
`python -m pytest tests/test_torch_cuda.py -m cuda`.
"""

import pytest
import torch

from ron_tensorflow_tpu_torch import kernels
from ron_tensorflow_tpu_torch.kernels import (
    fused_vgg_block1,
    fused_vgg_block1_plain,
    nms_fixpoint_keep_mask,
    nms_fixpoint_keep_mask_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def sorted_rows(seed, r, k, grid=None):
    g = torch.Generator().manual_seed(seed)
    cy, cx = torch.rand(2, r, k, generator=g) * 0.6 + 0.2
    h, w = torch.rand(2, r, k, generator=g) * 0.35 + 0.05
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    if grid:
        boxes = torch.round(boxes * grid) / grid
    scores = torch.where(torch.rand(r, k, generator=g) < 0.2, 0.0, torch.rand(r, k, generator=g))
    scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return scores.contiguous(), torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()


@pytest.mark.parametrize("mode", ["min", "union"])
@pytest.mark.parametrize("r,k,grid,thr", [(640, 200, None, 0.4), (33, 1024, 8, 0.5), (5, 31, 4, 0.25)])
def test_nms_kernel_equals_plain(cuda, r, k, grid, thr, mode):
    scores, boxes = (t.to(cuda) for t in sorted_rows(r + k, r, k, grid))
    kernels.reset_launch_counts()
    got = nms_fixpoint_keep_mask(scores, boxes, thr, mode)
    torch.cuda.synchronize()
    assert nms_fixpoint_keep_mask.launches == 1
    ref = nms_fixpoint_keep_mask_plain(scores, boxes, thr, mode)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", [(1, 16, 32), (2, 36, 52), (1, 8, 12), (2, 320, 320)])
def test_block1_kernel_within_bf16_of_plain(cuda, shape):
    """Tolerance: both round conv1_1 to bf16 and the output to bf16; their
    f32 sums differ in order, so an output may land one bf16 ulp (at most
    2^-7 of its value: rtol) apart, and a conv1_1 value that rounds the
    other way shifts the outputs it feeds by |w2| times its ulp (atol)."""
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(*shape, 3, generator=g) * 60).to(torch.bfloat16).to(cuda)
    w1 = (torch.randn(64, 3, 3, 3, generator=g) * 0.1).to(cuda)
    b1 = torch.randn(64, generator=g).to(cuda)
    w2 = (torch.randn(64, 64, 3, 3, generator=g) * 0.05).to(cuda)
    b2 = torch.randn(64, generator=g).to(cuda)
    kernels.reset_launch_counts()
    got = fused_vgg_block1(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_vgg_block1.launches == 1
    ref = fused_vgg_block1_plain(x, w1, b1, w2, b2)
    assert got.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    torch.testing.assert_close(got.float(), ref.float(), rtol=8e-3, atol=0.1)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    scores, boxes = (t.to(cuda) for t in sorted_rows(0, 2, 8))
    with pytest.raises(TypeError):
        nms_fixpoint_keep_mask(scores.double(), boxes.double())
    with pytest.raises(ValueError):
        nms_fixpoint_keep_mask(scores[:, ::2], boxes[:, ::2])
    x = torch.zeros(1, 7, 8, 3, dtype=torch.bfloat16, device=cuda)
    w1, w2 = torch.zeros(64, 3, 3, 3, device=cuda), torch.zeros(64, 64, 3, 3, device=cuda)
    b = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):
        fused_vgg_block1(x, w1, b, w2, b)  # odd height
