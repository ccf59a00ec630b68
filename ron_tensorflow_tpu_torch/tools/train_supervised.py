#!/usr/bin/env python
"""Long-run training supervisor for the card: restart on exit 75
(EX_TEMPFAIL) with a CUDA device probe between runs.

    python3 ron_tensorflow_tpu_torch/tools/train_supervised.py [--max-restarts N]
        [--probe-timeout S] [--probe-interval S] [--python PY] -- <train command and args...>
e.g.
    python3 ron_tensorflow_tpu_torch/tools/train_supervised.py -- \\
        python3 -m ron_tensorflow_tpu_torch.cli train --preset ron_320 \\
            --dataset-dir /data/voc --model-dir /models/ron320 max_steps=120000

A port of `tools/train_supervised.py` with the same flags and exit-code
contract, for a host with torch and a CUDA card (and no JAX). The Trainer's
failure-containment contract (`train/trainer.py`):
  - exit 75: the host-RSS guard (`max_host_rss_gb`) saved the current step
    and asks to be restarted; the Trainer resumes from that checkpoint;
  - a crash or a kill: the Trainer resumes from the last periodic save;
  - exit 0: `max_steps` reached, done.

Any command is accepted after `--`; the supervisor only reads exit codes.
It relaunches on exit 75 (always) and on any other non-zero exit (up to
--max-restarts), and stops on exit 0. Before each relaunch it waits until
the card answers a trivial computation, run in a subprocess that it kills
after --probe-timeout seconds (a hung dispatch blocks forever). The probe
needs CUDA: on a host without a card it fails, and the supervisor keeps
waiting rather than take the CPU as ready. The tool imports only the
standard library; `--python` names the interpreter of the probe.
"""

import argparse
import os
import subprocess
import sys
import time

PROBE = (
    "import torch;"
    "torch.ones((256, 256), device='cuda').sum().item();"
    "print('probe-ok')"
)


def device_ready(timeout: float, python: str) -> bool:
    """Run a trivial computation on the card in a killable subprocess."""
    try:
        out = subprocess.run(
            [python, "-c", PROBE],
            timeout=timeout,
            capture_output=True,
            text=True,
            env=os.environ,
        )
        return out.returncode == 0 and "probe-ok" in out.stdout
    except subprocess.TimeoutExpired:
        return False


def wait_for_device(timeout: float, interval: float, python: str) -> None:
    t0 = time.time()
    while not device_ready(timeout, python):
        waited = time.time() - t0
        print(
            f"[supervisor] CUDA device probe hung/failed after {waited:.0f}s total — "
            f"retrying in {interval:.0f}s",
            flush=True,
        )
        time.sleep(interval)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument(
        "--max-restarts",
        type=int,
        default=100,
        help="restart budget for CRASH exits (exit 75 restarts are free: "
        "they are the trainer asking politely)",
    )
    ap.add_argument(
        "--probe-timeout",
        type=float,
        default=120.0,
        help="seconds before a hung device probe counts as wedged",
    )
    ap.add_argument(
        "--probe-interval", type=float, default=60.0, help="seconds between probes"
    )
    ap.add_argument(
        "--python", default=sys.executable, help="interpreter for the device probe"
    )
    ap.add_argument("command", nargs=argparse.REMAINDER, help="-- <train command>")
    args = ap.parse_args(argv)

    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no training command given (put it after --)")

    crashes = 0
    attempt = 0
    while True:
        attempt += 1
        print(f"[supervisor] launch #{attempt}: {' '.join(cmd)}", flush=True)
        t0 = time.time()
        rc = subprocess.call(cmd, env=os.environ)
        dt = time.time() - t0
        if rc == 0:
            print(f"[supervisor] run completed after {dt:.0f}s — done", flush=True)
            return 0
        if rc == 75:
            print(
                f"[supervisor] EX_TEMPFAIL after {dt:.0f}s (checkpointed restart "
                "point) — relaunching",
                flush=True,
            )
        else:
            crashes += 1
            print(
                f"[supervisor] abnormal exit {rc} after {dt:.0f}s "
                f"(crash {crashes}/{args.max_restarts})",
                flush=True,
            )
            if crashes > args.max_restarts:
                print("[supervisor] restart budget exhausted — giving up", flush=True)
                return rc
        wait_for_device(args.probe_timeout, args.probe_interval, args.python)


if __name__ == "__main__":
    sys.exit(main())
