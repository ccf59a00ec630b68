"""VGG blocks 1-2 (conv1_1 .. pool2) on the card against an explicit HBM
traffic model: fwd, fwd+bwd with the activations saved, and fwd+bwd with
the span recomputed in the backward. The port of the JAX package's
`tools/perf_remat12_bandwidth.py`.

    python -m ron_tensorflow_tpu_torch.tools.perf_remat12_bandwidth [bs]

The span is `models/vgg.py`'s own: `vgg16_blocks12` over conv1_1, conv1_2,
conv2_1 and conv2_2 (port `Conv`s, bf16, flax's initializers from seed 0),
and for the third condition `remat_blocks12`, the mechanism of
`VGG16Backbone(remat_blocks12=True)`: `torch.utils.checkpoint` over the
span, only its input saved. fwd+bwd takes the gradient of sum(y^2) (f32)
with respect to the parameters.

The traffic model and the FLOPs are the JAX tool's, copied (bf16, conv
outputs written to HBM, the pool fused with its producer):

  fwd:   read in + (write+read) conv1_1, conv1_2, pool1, conv2_1, conv2_2
         + write pool2
  bwd:   the mirror-image cotangent chain (same tensor sizes), plus one
         read of each saved activation needed by the conv/relu VJPs
         (conv inputs: in, a1, p1, b1  -- and relu masks a1, a2, b1, b2)
  remat: bwd first reruns the whole fwd chain (same traffic again), then
         runs the same cotangent chain: on a bandwidth-bound span the
         recomputed tensors stream through HBM like saved ones, so remat
         adds a forward's worth of traffic; it trades FLOPs for memory
         capacity, not bandwidth.

Achieved GB/s and TFLOP/s are printed beside the H100's figures
(`perf_common`: 3350 GB/s, 989 TFLOP/s bf16). The model is written for
320 x 320 inputs; `--model ron_tiny_vgg` (the CPU tests) runs the span at
64 x 64 and counts its traffic at that side.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .. import resolve_device
from ..models import get_spec
from ..models.layers import Conv, init_like_flax_
from ..models.vgg import remat_blocks12, vgg16_blocks12
from .perf_common import ITERS, PEAK_BF16_TFLOPS, PEAK_HBM_GBPS, WARMUP, card_line, parser, timeit

BATCH = 32


class Span(nn.Module):
    """conv1_1 .. conv2_2 under their `VGG16Backbone` names."""

    def __init__(self):
        super().__init__()
        self.conv1_1, self.conv1_2 = Conv(3, 64), Conv(64, 64)
        self.conv2_1, self.conv2_2 = Conv(64, 128), Conv(128, 128)


def traffic_gb(bs: int, side: int = 320) -> Dict[str, float]:
    """The JAX tool's traffic model in GB: {"fwd", "saved", "remat"}."""
    e_in = side * side * 3
    a = side * side * 64  # conv1_1 / conv1_2 outputs
    p1 = (side // 2) ** 2 * 64
    b = (side // 2) ** 2 * 128  # conv2_1 / conv2_2 outputs
    p2 = (side // 4) ** 2 * 128
    fwd_elems = e_in + 2 * (a + a + p1 + b + b) + p2
    bwd_elems = fwd_elems + (e_in + a + p1 + b) + (a + a + b + b) + (a + b)
    to_gb = lambda e: e * 2 * bs / 1e9  # noqa: E731
    return {"fwd": to_gb(fwd_elems), "saved": to_gb(fwd_elems + bwd_elems), "remat": to_gb(2 * fwd_elems + bwd_elems)}


def span_flops(bs: int, side: int = 320) -> int:
    """The JAX tool's forward FLOPs of the span."""
    half = side // 2
    return 2 * bs * (side * side * (3 * 64 + 64 * 64) + half * half * (64 * 128 + 128 * 128)) * 9


def run(device="cuda", model="ron_320_vgg", bs=BATCH, iters=ITERS, warmup=WARMUP) -> Dict:
    """-> {condition: {"ms", "model_gb", "gb_s", "tflop_s"}, "remat_vs_saved", "traffic_ratio"}."""
    device = resolve_device(device)
    print(card_line(device))
    side = get_spec(model).img_shape[0]
    span = init_like_flax_(Span(), torch.Generator().manual_seed(0)).to(device)
    x = torch.randn((bs, 3, side, side), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16).to(device)
    params = list(span.parameters())

    def fwd():
        with torch.no_grad():
            return vgg16_blocks12(span, x)

    def grad(chain):
        return lambda: torch.autograd.grad((chain(span, x).float() ** 2).sum(), params)

    t_f = timeit(fwd, iters=iters, warmup=warmup, device=device)
    t_g = timeit(grad(vgg16_blocks12), iters=iters, warmup=warmup, device=device)
    t_gr = timeit(grad(remat_blocks12), iters=iters, warmup=warmup, device=device)

    gb = traffic_gb(bs, side)
    flops_f = span_flops(bs, side)
    print(f"batch {bs}  (bf16; H100 peak {PEAK_BF16_TFLOPS:g} TFLOP/s, HBM {PEAK_HBM_GBPS:g} GB/s)")
    print(f"{'condition':28s} {'ms':>8s} {'model GB':>9s} {'GB/s':>7s} {'TFLOP/s':>8s} {'%HBM':>5s} {'%peak':>5s}")
    res = {}
    for name, t, g, fl in [
        ("span fwd", t_f, gb["fwd"], flops_f),
        ("span fwd+bwd (saved acts)", t_g, gb["saved"], 3 * flops_f),
        ("span fwd+bwd (remat)", t_gr, gb["remat"], 4 * flops_f),
    ]:
        gbs, tfs = g / t, fl / t / 1e12
        res[name] = {"ms": t * 1e3, "model_gb": g, "gb_s": gbs, "tflop_s": tfs}
        print(f"{name:28s} {t * 1e3:8.2f} {g:9.2f} {gbs:7.0f} {tfs:8.1f} {gbs / PEAK_HBM_GBPS * 100:5.1f} "
              f"{tfs / PEAK_BF16_TFLOPS * 100:5.1f}", flush=True)
    res["remat_vs_saved"] = t_g / t_gr
    res["traffic_ratio"] = gb["saved"] / gb["remat"]
    print(f"remat vs saved: {res['remat_vs_saved']:.3f}x  (modelled traffic ratio {res['traffic_ratio']:.3f})")
    return res


def main(argv=None) -> Dict:
    ap = parser(__doc__)
    ap.add_argument("bs", type=int, nargs="?", default=BATCH, help=f"batch size (default {BATCH})")
    args = ap.parse_args(argv)
    return run(args.device, args.model, args.bs, args.iters, args.warmup)


if __name__ == "__main__":
    main()
