"""Per-module timing of the RON-320 forward and backward on the card: each
VGG block and each head type alone, fwd and fwd+bwd, with its FLOP count
and its share of the card's bf16 peak, so that the gap to the roofline can
be put on a module. The port of the JAX package's
`tools/perf_block_times.py`.

    python -m ron_tensorflow_tpu_torch.tools.perf_block_times [batch] [peak_tflops]

The ten cases are built from the port's modules, bf16, flax's initializers
from seed 0 (`models/layers.py::init_like_flax_`): a block is `Conv`s
(conv + bias + ReLU, XLA's SAME padding) and a 2x2 SAME max pool
(`layers.max_pool`); the heads are `models/ron.py`'s `ClsHead`,
`ObjectnessHead` and `BoxHead` in train mode (BatchNorm on batch
statistics), as the JAX tool builds them. fwd runs without autograd;
fwd+bwd takes the gradient of sum(y^2) (f32) with respect to the module's
parameters, as `jax.grad` of the JAX tool's loss does. The FLOP counts
are the JAX tool's formulas (`conv_flops`, the per-case sums), fwd+bwd
counted as 3x fwd. `peak_tflops` defaults to the H100's 989 TFLOP/s bf16
dense (`perf_common`). The sides follow the network's input: at RON-320
the JAX tool's 320, 160, ..., 10; `--model ron_tiny_vgg` (the CPU tests)
scales them from 64.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .. import resolve_device
from ..models import get_spec
from ..models.layers import Conv, init_like_flax_, max_pool
from ..models.ron import BoxHead, ClsHead, ObjectnessHead
from .perf_common import ITERS, PEAK_BF16_TFLOPS, WARMUP, card_line, parser, timeit

BATCH = 32


def conv_flops(h, w, cin, cout, kh=3, kw=3):
    return 2 * h * w * cin * cout * kh * kw


class Block(nn.Module):
    """Convs ((cout, kernel, dilation), ...) from `cin` channels, then a 2x2
    SAME max pool."""

    def __init__(self, cin: int, convs):
        super().__init__()
        self.convs = tuple(convs)
        layers = []
        for f, k, d in self.convs:
            layers.append(Conv(cin, f, kernel=(k, k), dilation=(d, d)))
            cin = f
        self.body = nn.ModuleList(layers)

    def forward(self, x, train: bool = False):
        for conv in self.body:
            x = conv(x)
        return max_pool(x, (2, 2), (2, 2), "SAME")


def cases(side: int = 320):
    """(name, input (H, W, C), module) of the JAX tool, with a network
    input of `side` (320 gives the JAX tool's shapes)."""
    s = [side // 2 ** i for i in range(6)]  # 320, 160, 80, 40, 20, 10
    return [
        (f"block1 {s[0]}^2 3->64x2", (s[0], s[0], 3), Block(3, ((64, 3, 1), (64, 3, 1)))),
        (f"block2 {s[1]}^2 64->128x2", (s[1], s[1], 64), Block(64, ((128, 3, 1), (128, 3, 1)))),
        (f"block3 {s[2]}^2 128->256x3", (s[2], s[2], 128), Block(128, ((256, 3, 1),) + ((256, 3, 1),) * 2)),
        (f"block4 {s[3]}^2 256->512x3", (s[3], s[3], 256), Block(256, ((512, 3, 1),) * 3)),
        (f"block5 {s[4]}^2 512x3", (s[4], s[4], 512), Block(512, ((512, 3, 1),) * 3)),
        (f"fc6/7 {s[5]}^2 512->1024", (s[5], s[5], 512), Block(512, ((1024, 3, 3), (1024, 1, 1)))),
        (f"cls_head {s[3]}^2", (s[3], s[3], 512), ClsHead(10, 21)),
        (f"cls_head {s[4]}^2", (s[4], s[4], 512), ClsHead(10, 21)),
        (f"obj_head {s[3]}^2", (s[3], s[3], 512), ObjectnessHead(10)),
        (f"box_head {s[3]}^2", (s[3], s[3], 512), BoxHead(10)),
    ]


def case_flops(mod, ishape, bs: int) -> int:
    """The JAX tool's FLOP estimate of one forward of `mod` at batch `bs`."""
    flops = 0
    h, w, cin = ishape
    if isinstance(mod, Block):
        for f, k, d in mod.convs:
            flops += conv_flops(h, w, cin, f, k, k)
            cin = f
    elif isinstance(mod, ClsHead):
        flops = (
            conv_flops(h, w, 512, 512) + conv_flops(h, w, 512, 512, 1, 1)
            + conv_flops(h, w, 1024, 512) + conv_flops(h, w, 1024, 512, 1, 1)
            + conv_flops(h, w, 1024, 210)
        )
    elif isinstance(mod, ObjectnessHead):
        flops = conv_flops(h, w, 512, 512) + conv_flops(h, w, 512, 20)
    elif isinstance(mod, BoxHead):
        flops = conv_flops(h, w, 512, 512) + conv_flops(h, w, 512, 40)
    return flops * bs


def run(device="cuda", model="ron_320_vgg", bs=BATCH, peak_tf=PEAK_BF16_TFLOPS, iters=ITERS, warmup=WARMUP) -> Dict:
    """-> {case: {"fwd_ms", "fwd_eff_pct", "fwdbwd_ms", "fwdbwd_eff_pct", "flops"}}."""
    device = resolve_device(device)
    print(card_line(device))
    print(f"batch {bs}, assumed bf16 peak {peak_tf} TFLOP/s")
    print(f"{'module':24s} {'fwd ms':>8s} {'eff%':>5s}  {'fwd+bwd ms':>10s} {'eff%':>5s}")
    rows = {}
    for name, ishape, mod in cases(get_spec(model).img_shape[0]):
        init_like_flax_(mod, torch.Generator().manual_seed(0))
        mod.to(device)
        h, w, c = ishape
        g = torch.Generator().manual_seed(0)
        x = torch.randn((bs, c, h, w), generator=g).to(torch.bfloat16).to(device)
        params = list(mod.parameters())

        def fwd():
            with torch.no_grad():
                return mod(x, train=True)

        def fwdbwd():
            y = mod(x, train=True)
            return torch.autograd.grad((y.float() ** 2).sum(), params)

        t_f = timeit(fwd, iters=iters, warmup=warmup, device=device)
        t_g = timeit(fwdbwd, iters=iters, warmup=warmup, device=device)
        flops = case_flops(mod, ishape, bs)
        eff_f = flops / t_f / 1e12 / peak_tf * 100
        eff_g = 3 * flops / t_g / 1e12 / peak_tf * 100
        rows[name] = {"fwd_ms": t_f * 1e3, "fwd_eff_pct": eff_f, "fwdbwd_ms": t_g * 1e3, "fwdbwd_eff_pct": eff_g,
                      "flops": flops}
        print(f"{name:24s} {t_f * 1e3:8.2f} {eff_f:5.1f}  {t_g * 1e3:10.2f} {eff_g:5.1f}", flush=True)
    return rows


def main(argv=None) -> Dict:
    ap = parser(__doc__)
    ap.add_argument("batch", type=int, nargs="?", default=BATCH, help=f"batch size (default {BATCH})")
    ap.add_argument("peak", type=float, nargs="?", default=PEAK_BF16_TFLOPS,
                    help=f"bf16 peak in TFLOP/s (default: the H100's {PEAK_BF16_TFLOPS:g})")
    args = ap.parse_args(argv)
    return run(args.device, args.model, args.batch, args.peak, args.iters, args.warmup)


if __name__ == "__main__":
    main()
