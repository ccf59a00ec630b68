"""Exact top-k selection on the detection shapes, standalone and inside the
Detector. The port of the JAX package's `tools/perf_topk.py`.

    python -m ron_tensorflow_tpu_torch.tools.perf_topk [batch]

Standalone, on [batch, 20, 21250] uniform scores at k = 200 with the JAX
tool's sparsity (every score above 0.03 set to exactly 0, as the gate
leaves most of them): `torch.topk`, and `ops/math.py::exact_top_k_chunked`
at 4, 8, 16 and 32 chunks. Before timing, every chunked result must equal,
bit for bit and indices included, one stable descending `torch.sort` of
the row (that sort gives `lax.top_k`'s tie order, the lower index first),
and `torch.topk`'s values must equal its values (its tie order among the
zeros is not promised on the card); any difference raises. The JAX tool's
`approx_max_k` row has no counterpart: the port selects exactly.

Then the whole Detector (forward and postprocess) at that batch under the
JAX tool's five `DetectionConfig` rows, bf16 RON-320 from seed 0
(`bench.seeded_network`), block 1 through K-B on the card, NMS through
K-A. The two "approx" rows keep their JAX names: in the port
`approx_top_k` selects exactly, so they time the exact selection (and the
last one `shared_top_k=1000`'s preselection, which also runs
`exact_top_k_chunked`).
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import resolve_device
from ..bench import seeded_network
from ..inference.detector import DetectionConfig, Detector
from ..ops.math import exact_top_k_chunked
from .perf_common import ITERS, WARMUP, card_line, parser, timeit

BATCH = 32
N, C, K = 21250, 20, 200
CHUNKS = (4, 8, 16, 32)
E2E_ROWS = {
    "exact (default)": DetectionConfig(),
    "exact chunked 8": DetectionConfig(topk_chunks=8),
    "exact chunked 16": DetectionConfig(topk_chunks=16),
    "approx (old default)": DetectionConfig(approx_top_k=True),
    "approx+shared (r1-r4 bench)": DetectionConfig(approx_top_k=True, shared_top_k=1000),
}


def sparse_scores(batch: int, device, n: int = N) -> torch.Tensor:
    """[batch, 20, n] uniforms, those above 0.03 set to 0 (seed 0)."""
    x = torch.rand((batch, C, n), generator=torch.Generator().manual_seed(0)).to(device)
    return torch.where(x > 0.03, torch.zeros((), device=device), x)


def check_selections(x: torch.Tensor, k: int = K) -> None:
    """Raise unless every chunked top-k equals one stable descending sort,
    values and indices, and `torch.topk`'s values equal its values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    for nc in CHUNKS:
        got_v, got_i = exact_top_k_chunked(x, k, nc)
        if not (torch.equal(got_v, vals) and torch.equal(got_i, idx)):
            raise AssertionError(f"exact_top_k_chunked({nc}) differs from the stable sort's top-{k}")
    if not torch.equal(torch.topk(x, k).values, vals):
        raise AssertionError(f"torch.topk's values differ from the stable sort's top-{k}")


def run(device="cuda", model="ron_320_vgg", batch=BATCH, iters=ITERS, warmup=WARMUP) -> Dict:
    """-> {"standalone": {label: ms}, "e2e": {label: {"ms", "img_s"}}}. The
    standalone rows take 3/2 of `iters` timed calls (the JAX tool's 30
    against the Detector's 20)."""
    device = resolve_device(device)
    standalone_iters = max(1, iters * 3 // 2)
    print(card_line(device))
    x = sparse_scores(batch, device)
    check_selections(x)
    res = {"standalone": {}, "e2e": {}}
    print(f"standalone [B={batch}, C-1={C}, N={N}] k={K} (chunked results bit-equal to a stable sort):")
    t = timeit(lambda: torch.topk(x, K), iters=standalone_iters, warmup=warmup, device=device)
    res["standalone"]["torch.topk"] = t * 1e3
    print(f"  torch.topk           {t * 1e3:7.2f} ms", flush=True)
    for nc in CHUNKS:
        t = timeit(lambda nc=nc: exact_top_k_chunked(x, K, nc), iters=standalone_iters, warmup=warmup, device=device)
        res["standalone"][f"chunked({nc})"] = t * 1e3
        print(f"  chunked({nc:2d})          {t * 1e3:7.2f} ms", flush=True)

    net, spec = seeded_network(model, torch.bfloat16, fuse_block1=device.type == "cuda")
    image = torch.randn((batch, *spec.img_shape, 3), generator=torch.Generator().manual_seed(0)).to(device)
    print(f"e2e Detector (fwd+postproc), batch {batch} (approx_top_k selects exactly):")
    for name, cfg in E2E_ROWS.items():
        det = Detector(net, spec, cfg, device=device)
        t = timeit(lambda: det(image), iters=iters, warmup=warmup, device=device)
        res["e2e"][name] = {"ms": t * 1e3, "img_s": batch / t}
        print(f"  {name:28s} {t * 1e3:7.2f} ms  -> {batch / t:6.1f} img/s", flush=True)
    return res


def main(argv=None) -> Dict:
    ap = parser(__doc__)
    ap.add_argument("batch", type=int, nargs="?", default=BATCH, help=f"batch size (default {BATCH})")
    args = ap.parse_args(argv)
    return run(args.device, args.model, args.batch, args.iters, args.warmup)


if __name__ == "__main__":
    main()
