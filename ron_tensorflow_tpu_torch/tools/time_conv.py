"""Time the conv kernels K-D and K-E of one copy of the port on the card.

    python3 ron_tensorflow_tpu_torch/tools/time_conv.py [ROOT]

ROOT (default: the checkout that holds this script) is the directory whose
`ron_tensorflow_tpu_torch` package is timed, for example a `git archive` of
another commit unpacked under the gitignored `_checkouts/`. To compare two
versions of a kernel, run the script once per copy, in turns (A, B, B, A),
in one call on the card. Prints one JSON line: for K-D on random input and
on relu(conv1_1) of the trained fixture's four images tiled to batch 32,
and for K-E on the VGG block-2 and block-3 tails' shapes with random input,
the mean milliseconds of 20 launches after one warm-up (CUDA events) and
the first 12 hex digits of a SHA-256 of the output's bits.
"""

import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FIXTURE = REPO / "tests" / "fixtures" / "e2e_parity_trained.npz"


def main(root):
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ron_tensorflow_tpu_torch import kernels
    from ron_tensorflow_tpu_torch.data.preprocess import eval_preprocess
    from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC
    from ron_tensorflow_tpu_torch.weights import from_jax_params, load_trained_fixture

    if not torch.cuda.is_available():
        raise SystemExit("time_conv.py needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    state = from_jax_params(*load_trained_fixture(str(FIXTURE)))
    fx = np.load(FIXTURE, allow_pickle=False)
    images = torch.stack([
        eval_preprocess(torch.as_tensor(fx[f"img_{i}_pixels"], device="cuda").float() / 255.0,
                        RON_320_SPEC.img_shape)[0]
        for i in ("1", "2", "3", "4")
    ])
    batch = images.repeat(8, 1, 1, 1).to(torch.bfloat16)
    w1, b1, w2, b2 = (state[f"backbone.conv1_{j}.conv.{p}"].cuda() for j in (1, 2) for p in ("weight", "bias"))
    y1 = F.relu(F.conv2d(batch.float().permute(0, 3, 1, 2), w1.to(torch.bfloat16).float(), b1.float(), padding=1))
    y1 = y1.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()

    def random_case(seed, shape, cin, cout):
        g = torch.Generator().manual_seed(seed)
        x = torch.relu(torch.randn(*shape, cin, generator=g) * 3).to(torch.bfloat16).cuda()
        w = (torch.randn(cout, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5).cuda()
        b = (torch.randn(cout, generator=g) * 0.1).cuda()
        return x, w, b

    def mean_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    result = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    for name, fn, args in (
        ("K-D trained", kernels.fused_stem_conv_relu_pool2, (y1, w2, b2)),
        ("K-D", kernels.fused_stem_conv_relu_pool2, random_case(1, (32, 320, 320), 64, 64)),
        ("K-E block2", kernels.fused_conv3x3_relu_pool2, random_case(2, (32, 160, 160), 128, 128)),
        ("K-E block3", kernels.fused_conv3x3_relu_pool2, random_case(3, (32, 80, 80), 256, 256)),
    ):
        out = fn(*args)
        bits = hashlib.sha256(out.cpu().view(torch.int16).numpy().tobytes()).hexdigest()[:12]
        result[name] = [mean_ms(lambda: fn(*args)), bits]
    print(json.dumps(result))


if __name__ == "__main__":
    main(Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else REPO)
