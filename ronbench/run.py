"""One run of one benchmark cell, on the card it is started on.

    python -m ronbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Prints one JSON line as the last line of
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` `breakdown`, and last `checks`, each number compared
beside its limit; the checks also end standard error. Exits non-zero,
printing no result, without enough CUDA devices for the cell, or when JAX
or the JAX package is loaded in this process once the window has closed.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here, before the heavy imports

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()

    from ronbench import harness

    harness.cache_dirs(root)
    import torch

    plan = harness.resolve(root, args.workload)
    chips = int(plan.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"ronbench: {plan.name} needs {chips} CUDA device(s), this machine has {seen}", file=sys.stderr)
        return 2
    result = harness.run_cell(plan, args.seed % 2**63, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"ronbench: JAX or the JAX package is loaded in this process: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
