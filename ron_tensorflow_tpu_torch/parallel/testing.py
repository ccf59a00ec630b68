"""Run a function in N local rank processes, for the tests and the smoke run.

    results = run_ranks("package.module:function", world=2, kwargs={...}, timeout=120)

Each rank is a fresh `python -m ron_tensorflow_tpu_torch.parallel.testing`
process that calls `function(rank, world, port, **kwargs)` and saves what
it returns (torch.save) for the parent; `port` is a free localhost port for
`initialize_distributed("127.0.0.1:<port>", world, rank, ...)`. The parent
waits at most `timeout` seconds for all of them. A rank that fails, or a
run that outlasts its time, kills every rank and raises with the tail of
each rank's log: a hung collective cannot outlive its caller.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

LOG_TAIL = 4000


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(target: str, world: int, kwargs: Optional[Dict] = None, timeout: float = 300.0,
              env: Optional[Dict[str, str]] = None, pythonpath: Sequence[str] = ()) -> List:
    """`target` ('module:function') in `world` rank processes; returns the
    ranks' results in rank order. `kwargs` must be JSON-serializable.
    `pythonpath` entries go before the inherited PYTHONPATH."""
    port = free_port()
    child_env = dict(os.environ if env is None else env)
    child_env["PYTHONPATH"] = os.pathsep.join([*pythonpath, str(Path(__file__).resolve().parents[2]),
                                               child_env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    with tempfile.TemporaryDirectory(prefix="ranks_") as out:
        procs, logs = [], []
        for rank in range(world):
            log = open(os.path.join(out, f"rank{rank}.log"), "w+")
            logs.append(log)
            cmd = [sys.executable, "-m", "ron_tensorflow_tpu_torch.parallel.testing", target, str(rank), str(world),
                   str(port), out, json.dumps(kwargs or {})]
            procs.append(subprocess.Popen(cmd, env=child_env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout} s"
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        tails = []
        for rank, log in enumerate(logs):
            log.seek(0)
            tails.append(f"--- rank {rank} ---\n{log.read()[-LOG_TAIL:]}")
            log.close()
        if failed:
            raise RuntimeError(f"{target}: {failed}\n" + "\n".join(tails))
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("target")
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("port", type=int)
    p.add_argument("out")
    p.add_argument("kwargs")
    a = p.parse_args(argv)
    module, _, name = a.target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    try:
        result = fn(a.rank, a.world, a.port, **json.loads(a.kwargs))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, os.path.join(a.out, f"rank{a.rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(_main())
