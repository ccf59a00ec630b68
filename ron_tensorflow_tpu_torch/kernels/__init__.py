"""Hand-written CUDA kernels for the H100, each beside its plain PyTorch
version. A wrapper launches its kernel for a CUDA tensor (or raises) and
runs the plain version only for a CPU tensor. `csrc/` holds the sources;
`_build` compiles them with one nvcc call at first use."""

from .fused_conv_pool import fused_block1_supported, fused_vgg_block1, fused_vgg_block1_plain
from .nms import nms_fixpoint_keep_mask, nms_fixpoint_keep_mask_plain, nms_sorted_kernel

KERNELS = (nms_fixpoint_keep_mask, fused_vgg_block1)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
