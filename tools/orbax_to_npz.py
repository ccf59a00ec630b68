"""Turn one step of a JAX model dir (orbax checkpoints, written by
`ron_tensorflow_tpu`'s `CheckpointManager`) into one npz that the PyTorch
port reads, on a host where JAX and orbax are installed.

    python tools/orbax_to_npz.py MODEL_DIR OUT.npz [--step N]

The step (the newest by default) is restored with orbax's
`StandardCheckpointer`, as the JAX trainer's orbax warm start restores a
checkpoint (ron_tensorflow_tpu/train/trainer.py:213), and written as
`params/<flax path>`, `batch_stats/<flax path>`, `ema_params/<flax path>`
(when the state has an EMA) and `step`. The optimizer state is left out.
In the port, `train.checkpoint.load_orbax_npz` reads the file,
`TrainConfig(checkpoint_format="orbax", checkpoint_path=OUT.npz)` warm-starts
from its `params`, and `weights.from_jax_params(params, batch_stats)` gives
a model's `state_dict`.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PARTS = ("params", "batch_stats", "ema_params")


def orbax_step_arrays(model_dir: str, step: Optional[int] = None) -> Dict[str, np.ndarray]:
    """{npz key: array} of step `step` (the newest by default) of `model_dir`."""
    import orbax.checkpoint as ocp

    from ron_tensorflow_tpu.train.checkpoint import CheckpointManager, flatten_params

    model_dir = os.path.abspath(model_dir)
    if step is None:
        step = CheckpointManager(model_dir).latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {model_dir}")
    restored = ocp.StandardCheckpointer().restore(os.path.join(model_dir, str(step), "default"))
    out = {"step": np.asarray(step, np.int64)}
    for part in PARTS:
        tree = restored.get(part)
        if tree is None:
            continue
        for key, leaf in flatten_params(tree).items():
            out[f"{part}/{key}"] = np.asarray(leaf)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_dir")
    p.add_argument("out")
    p.add_argument("--step", type=int, default=None)
    args = p.parse_args(argv)
    arrays = orbax_step_arrays(args.model_dir, args.step)
    np.savez(args.out, **arrays)
    counts = {part: sum(k.startswith(part + "/") for k in arrays) for part in PARTS}
    print(f"step {int(arrays['step'])} of {args.model_dir} -> {args.out}: "
          + ", ".join(f"{n} {part}" for part, n in counts.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
