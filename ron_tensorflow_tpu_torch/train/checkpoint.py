"""Train-state checkpoints with keep-N retention, in torch's own format.

The surface of `ron_tensorflow_tpu/train/checkpoint.py::CheckpointManager`
(`save`, `restore`, `latest_step`, `has_checkpoint`, `wait`; the
reference's `tf.train.Saver(max_to_keep=5)`, ron_net.py:395-418). Each
step is a directory `<step>/` holding `train_state.pt`: the whole
`TrainState.state_dict()` (step, parameters, BatchNorm buffers, optimizer
state, EMA) written with `torch.save`, to a temporary name first and then
renamed, so that a reader never sees half a file. Saves are synchronous;
`wait` has nothing to wait for. Warm start and the TF, Caffe and orbax
importers wait for the checkpoint slice (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

STATE_FILE = "train_state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):  # ref: ron_net.py:396
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self._dir):
            if name.isdigit() and os.path.exists(os.path.join(self._dir, name, STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def has_checkpoint(self) -> bool:
        return self.latest_step() is not None

    def save(self, step: int, state) -> None:
        """Write `state` (a `TrainState`) as step `step`, then drop all but
        the newest `max_to_keep` steps."""
        step_dir = os.path.join(self._dir, str(int(step)))
        os.makedirs(step_dir, exist_ok=True)
        path = os.path.join(step_dir, STATE_FILE)
        torch.save(state.state_dict(), path + ".tmp")
        os.replace(path + ".tmp", path)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)))

    def restore(self, state, step: Optional[int] = None):
        """Load step `step` (the latest by default) into `state` in place
        and return it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        saved = torch.load(os.path.join(self._dir, str(step), STATE_FILE), map_location="cpu", weights_only=True)
        state.load_state_dict(saved)
        return state

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""
