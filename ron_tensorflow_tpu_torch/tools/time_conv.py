"""Time the conv kernels K-B, K-D and K-E of one copy of the port on the card.

    python3 ron_tensorflow_tpu_torch/tools/time_conv.py [ROOT] [--trace]

ROOT (default: the checkout that holds this script) is the directory whose
`ron_tensorflow_tpu_torch` package is timed, for example a `git archive` of
another commit unpacked under the gitignored `_checkouts/`. To compare two
versions of a kernel, run the script once per copy, in turns (A, B, B, A),
in one call on the card. Prints one JSON line: for K-B at block 1 (the
trained fixture's four images tiled to batch 32, [32, 320, 320, 3] -> 64)
and at block 2 (that batch's pool1 through the model's conv2_1/conv2_2,
[32, 160, 160, 64] -> 128), for K-D on random input and on relu(conv1_1)
of the same batch, and for K-E on the VGG block-2 and block-3 tails'
shapes with random input: the mean milliseconds of 20 launches after one
warm-up (CUDA events) and the first 12 hex digits of a SHA-256 of the
output's bits. For K-B at block 2 on the first 14 images of that pool1
(the training batch) also the mean milliseconds of 10 forward + recompute
backward passes, of 10 forward + backward passes through the unfused
composition (`block1_reference`), and of 10 forwards, for one seeded
output gradient.

--trace (this copy only) builds the kernel library again with
-DRON_KB2_TRACE and prints, for block 2, the clock64() split of where a
tile's time goes: per role of the block-2 kernel (each consumer
warpgroup's thread 0, the weight producer, the first X loader), cycles a
tile averaged over the blocks, one JSON line.
"""

import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FIXTURE = REPO / "tests" / "fixtures" / "e2e_parity_trained.npz"


def main(root, trace=False):
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

    block2 = [state[f"backbone.conv2_{j}.conv.{p}"].cuda() for j in (1, 2) for p in ("weight", "bias")]
    with torch.inference_mode():
        pool1 = kernels.fused_vgg_block1(batch, w1, b1, w2, b2)
    if trace:
        print(json.dumps(block2_trace(pool1, block2)))
        return

    result = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    for name, fn, args in (
        ("K-B block1", kernels.fused_vgg_block1, (batch, w1, b1, w2, b2)),
        ("K-B block2", kernels.fused_vgg_block1, (pool1, *block2)),
        ("K-D trained", kernels.fused_stem_conv_relu_pool2, (y1, w2, b2)),
        ("K-D", kernels.fused_stem_conv_relu_pool2, random_case(1, (32, 320, 320), 64, 64)),
        ("K-E block2", kernels.fused_conv3x3_relu_pool2, random_case(2, (32, 160, 160), 128, 128)),
        ("K-E block3", kernels.fused_conv3x3_relu_pool2, random_case(3, (32, 80, 80), 256, 256)),
    ):
        with torch.inference_mode():
            out = fn(*args)
            bits = hashlib.sha256(out.cpu().view(torch.int16).numpy().tobytes()).hexdigest()[:12]
            result[name] = [mean_ms(lambda: fn(*args)), bits]
    result["K-B block2 b14 train"] = training_ms(pool1[:14].clone(), block2, mean_ms)
    print(json.dumps(result))


def training_ms(x, w, mean_ms):
    """[forward + recompute backward, unfused forward + backward, forward] ms of K-B on x with w."""
    import torch

    from ron_tensorflow_tpu_torch import kernels
    from ron_tensorflow_tpu_torch.kernels.fused_conv_pool import block1_reference

    b, h, wd, _ = x.shape
    go = torch.randn(b, h // 2, wd // 2, w[0].shape[0], device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    go = go.to(torch.bfloat16)

    def fwd_bwd(fn):
        leaves = [x] + [t.detach().requires_grad_() for t in w]
        return lambda: torch.autograd.grad(fn(*leaves), leaves[1:], go)

    return [mean_ms(fwd_bwd(kernels.fused_vgg_block1), reps=10), mean_ms(fwd_bwd(block1_reference), reps=10),
            mean_ms(lambda: kernels.fused_vgg_block1(x, *w), reps=10)]


# The block-2 kernel's trace slots (csrc/fused_vgg_block1.cu, RON_KB2_TRACE): for each consumer, and
# for the weight producer and the first X loader.
CONSUMER_SLOTS = ("total", "ring full waits", "X waits", "named barriers", "conv A to Y", "pool and store",
                  "conv A passes", "conv B passes", "ring full waits in conv B")
PRODUCER_SLOTS = ("total", "ring empty waits")
LOADER_SLOTS = ("total", "X empty waits")


def block2_trace(x, w):
    """Launch the traced build of the block-2 kernel once on x (NHWC bf16) with w = (w1, b1, w2, b2) as
    the wrapper would, and return the clock64() split: cycles a tile per role, averaged over blocks."""
    import numpy as np
    import torch

    from ron_tensorflow_tpu_torch.kernels import _build
    from ron_tensorflow_tpu_torch.kernels import fused_conv_pool as fcp

    defines = ("RON_KB2_TRACE",)
    lib = _build.library(defines)
    w1, b1, w2, b2 = w
    batch, height, width, cin = x.shape
    c = w1.shape[0]
    w1h = fcp._block2_weight_image(w1, fcp.SLAB_CI)
    w2h = fcp._block2_weight_image(w2, lib.fused_vgg_block2_conv_b_n(c))
    b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
    xb = x.to(torch.bfloat16).contiguous()
    out = torch.empty(batch, height // 2, width // 2, c, dtype=torch.bfloat16, device=x.device)
    err = lib.fused_vgg_block2(xb.data_ptr(), w1h.data_ptr(), b1f.data_ptr(), w2h.data_ptr(), b2f.data_ptr(),
                               out.data_ptr(), batch, height, width, cin, c, torch.cuda.current_stream().cuda_stream)
    _build.check("fused_vgg_block2 (traced)", err)
    torch.cuda.synchronize()
    blocks = lib.fused_vgg_block2_trace_blocks()
    buf = np.zeros((blocks, 4, lib.fused_vgg_block2_trace_slots()), dtype=np.int64)
    _build.check("fused_vgg_block2_trace", lib.fused_vgg_block2_trace(buf.ctypes.data))
    tiles = batch * -(-height // 8) * -(-width // 32)
    grid = int((buf[:, 0, 0] > 0).sum())  # the blocks the launch ran (consumer 0's total is set)
    per_tile = buf[:grid].mean(axis=0) * grid / tiles
    report = {"shape": [list(x.shape), c], "tiles": tiles, "blocks": grid, "device": torch.cuda.get_device_name(0),
              "ptxas": {k: v for k, v in _build.ptxas_report(defines).items() if "block2" in k}}
    for role, slots, row in ((f"consumer {g}", CONSUMER_SLOTS, per_tile[g]) for g in (0, 1)):
        report[role] = {name: round(float(v), 1) for name, v in zip(slots, row)}
    report["weight producer"] = {name: round(float(v), 1) for name, v in zip(PRODUCER_SLOTS, per_tile[2])}
    report["X loader"] = {name: round(float(v), 1) for name, v in zip(LOADER_SLOTS, per_tile[3])}
    return report


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--trace"]
    main(Path(args[0]).resolve() if args else REPO, trace="--trace" in sys.argv[1:])
