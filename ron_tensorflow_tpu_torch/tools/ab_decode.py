"""Time the image decode of this checkout's package against another
checkout's, in turns in one process, on the host CPU.

    python3 ron_tensorflow_tpu_torch/tools/ab_decode.py OTHER_ROOT [ROUNDS]

OTHER_ROOT is a copy of the repository (for example `git archive` of the
parent commit unpacked under the gitignored `_checkouts/`). Its package is
loaded beside this one under another name, with its own native decoder
(built by its `data/native.py`). Both decode the eight `voc_mini` JPEGs of
this checkout, `REPS` passes each, through the names both have:
`decode_jpeg_raw` (the original resolution), `decode_jpeg` to the 512x512
train canvas and `decode_jpeg_eval` to the 320x320 eval canvas, on one
thread and on the input pipeline's thread pool (`decode_workers=-1`: one
thread a core but one, at most 8), as `chip_smoke.py`'s phase "jpeg" does.
The sides first show that they decode to the same bits. Then, in the order
A B B A for each of ROUNDS rounds (default 2), each side's ms an image is
taken by the host clock.

Prints one JSON line: per side, each measure's per-turn ms an image.
"""

import importlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
JPEGS = REPO / "tests" / "fixtures" / "voc_mini" / "VOC2007" / "JPEGImages"
REPS = 16
TRAIN_HW, EVAL_HW = (512, 512), (320, 320)


def measures(name):
    """{measure: one-argument decode} of the package `name`."""
    decode = importlib.import_module(f"{name}.data.decode")
    return {"raw": decode.decode_jpeg_raw, "train_512": lambda b: decode.decode_jpeg(b, TRAIN_HW),
            "eval_320": lambda b: decode.decode_jpeg_eval(b, EVAL_HW, "WARP_RESIZE")}


def per_image_ms(fn, blobs, threads):
    fn(blobs[0])
    t0 = time.perf_counter()
    if threads == 1:
        for b in blobs:
            fn(b)
    else:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(fn, blobs))
    return (time.perf_counter() - t0) * 1e3 / len(blobs)


def main(other_root, rounds=2):
    sys.path.insert(0, str(REPO))
    from ron_tensorflow_tpu_torch.tools.ab_eval import load_package

    load_package(other_root, "other_port")
    sides = {"A (this checkout)": measures("ron_tensorflow_tpu_torch"), "B (other)": measures("other_port")}
    blobs = [p.read_bytes() for p in sorted(JPEGS.glob("*.jpg"))]
    for measure in ("raw", "train_512", "eval_320"):
        a, b = (s[measure] for s in sides.values())
        if not all(np.array_equal(a(x), b(x)) for x in blobs):
            raise AssertionError(f"the two checkouts' {measure} decodes differ")
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    out = {side: {f"{m}_{n}_threads": [] for m in ("raw", "train_512", "eval_320") for n in (1, workers)}
           for side in sides}
    for _ in range(rounds):
        for side in list(sides) + list(sides)[::-1]:
            for measure, fn in sides[side].items():
                for n in (1, workers):
                    out[side][f"{measure}_{n}_threads"].append(per_image_ms(fn, blobs * REPS, n))
    print(json.dumps({"images": len(blobs), "reps": REPS, "cores": os.cpu_count(), "ms_per_image": out}))


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:3]))
