"""Where RON-320 inference time goes on the card: the forward against the
postprocess (decode, gate, exact per-class top-k, NMS), at several batch
sizes. The port of the JAX package's `tools/perf_breakdown.py`.

    python -m ron_tensorflow_tpu_torch.tools.perf_breakdown [--batches 1 8 32 64]

The model is bf16 RON-320 with flax's initializers drawn from seed 0
(`bench.seeded_network`), block 1 through K-B on the card (the production
inference path, as the JAX tool clones `fuse_block1=True` off the CPU); the
Detector's default `DetectionConfig` runs K-A there. Inputs are standard
normal pixels. Each row times, by `perf_common.timeit`: the forward alone,
the postprocess alone on that forward's outputs, and the whole Detector
call. `--device cpu --model ron_tiny_vgg` runs the same code on the CPU
(plain K-B and the CPU NMS) for the tests; its times are the host's.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import resolve_device
from ..bench import seeded_network
from ..inference.detector import DetectionConfig, Detector
from .perf_common import ITERS, WARMUP, card_line, parser, timeit

BATCHES = (1, 8, 32, 64)


def run(device="cuda", model="ron_320_vgg", batches=BATCHES, iters=ITERS, warmup=WARMUP) -> Dict:
    """-> {batch: {"fwd_ms", "post_ms", "full_ms", "img_s", "fwd_img_s"}}."""
    device = resolve_device(device)
    print(card_line(device))
    net, spec = seeded_network(model, torch.bfloat16, fuse_block1=device.type == "cuda")
    detector = Detector(net, spec, DetectionConfig(), device=device)
    rows = {}
    for batch in batches:
        img = torch.randn((batch, *spec.img_shape, 3), generator=torch.Generator().manual_seed(0)).to(device)
        with torch.inference_mode():
            t_fwd = timeit(lambda: net(img), iters=iters, warmup=warmup, device=device)
            out = net(img)
            t_post = timeit(lambda: detector.postprocess(out), iters=iters, warmup=warmup, device=device)
        t_full = timeit(lambda: detector(img), iters=iters, warmup=warmup, device=device)
        rows[batch] = {"fwd_ms": t_fwd * 1e3, "post_ms": t_post * 1e3, "full_ms": t_full * 1e3,
                       "img_s": batch / t_full, "fwd_img_s": batch / t_fwd}
        print(
            f"batch {batch:3d}: fwd {t_fwd * 1e3:7.2f} ms  post {t_post * 1e3:7.2f} ms  "
            f"full {t_full * 1e3:7.2f} ms  -> {batch / t_full:7.1f} img/s "
            f"(fwd-only {batch / t_fwd:7.1f} img/s)", flush=True)
    return rows


def main(argv=None) -> Dict:
    ap = parser(__doc__)
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES),
                    help="batch sizes (default: the JAX tool's 1 8 32 64)")
    args = ap.parse_args(argv)
    return run(args.device, args.model, tuple(args.batches), args.iters, args.warmup)


if __name__ == "__main__":
    main()
