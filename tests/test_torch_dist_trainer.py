"""The port's Trainer in two gloo processes on the CPU (the tiny RON, RON-320's
widths): data-parallel on mesh (2, 1) with the Grain-equivalent pipeline, and
tensor-parallel on (1, 2).

- The ranks' whole states (parameters and BatchNorm statistics, the
  'model' slices gathered) are bit-identical.
- Rank 0's checkpoint, written in the one-process format, restores in one
  process (a one-process Trainer resumes there) to the same tensors.
- A run stopped at step 2 and resumed to 4 (each rank restoring its own
  `input_state_{rank}.json`, its shard's position) equals the straight run
  to 4, bit for bit; the two ranks read disjoint index shards.

Slow: each run starts two processes, each initializing, broadcasting and
saving a 94 M-parameter state (~1 GB with the momentum).
"""

import shutil
import sys
from pathlib import Path

import pytest

from ron_tensorflow_tpu_torch.config import TrainConfig, apply_overrides
from ron_tensorflow_tpu_torch.parallel.testing import run_ranks
from ron_tensorflow_tpu_torch.train.trainer import Trainer

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
from test_grain import _write_shard  # noqa: E402
from torch_dist_workers import digest  # noqa: E402

RUN_TIMEOUT = 600  # seconds for one two-process Trainer run, start-up and saves included

pytestmark = pytest.mark.slow


@pytest.fixture
def records(tmp_path):
    _write_shard(tmp_path, n=16, name="g_train_000.tfrecord")
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def overrides(root, model_dir, mesh, steps):
    return ["model=ron_tiny_vgg", f"model_dir={root / model_dir}", f"data.dataset_dir={root}",
            "data.file_pattern=g_train_*.tfrecord", "data.batch_size=2", "data.max_boxes=4",
            "data.working_shape=[48, 48]", "data.use_grain=true", "bfloat16=false", f"max_steps={steps}",
            "log_every_steps=1", "save_every_steps=2", "max_to_keep=1", "tensorboard=false",
            "optimizer.learning_rate=0.001", "optimizer.learning_rate_decay_type=fixed", f"mesh_shape={mesh}"]


def train(root, model_dir, mesh, steps):
    return run_ranks("torch_dist_workers:trainer_worker", 2,
                     dict(overrides=overrides(root, model_dir, mesh, steps), max_steps=steps),
                     timeout=RUN_TIMEOUT, pythonpath=[str(TESTS)])


def one_process_restore(root, model_dir, mesh, steps):
    cfg = apply_overrides(TrainConfig(), overrides(root, model_dir, mesh, steps)[:-1])
    state = Trainer(cfg, device="cpu").init_state()
    return state.step, digest({**state.params, **state.batch_stats})


def test_data_parallel_trainer_with_grain_resume(records):
    straight = train(records, "straight", "[2, 1]", 4)
    assert [r["step"] for r in straight] == [4, 4]
    assert straight[0]["digest"] == straight[1]["digest"]
    # each rank reads its own index shard: positions of shard 0 and 1 of 2
    states = [r["input_state"] for r in straight]
    assert [s["sampler"].split("shard_index=")[1][0] for s in states] == ["0", "1"]
    assert one_process_restore(records, "straight", "[2, 1]", 4) == (4, straight[0]["digest"])

    first = train(records, "broken", "[2, 1]", 2)
    assert [r["step"] for r in first] == [2, 2]
    resumed = train(records, "broken", "[2, 1]", 4)
    assert [r["step"] for r in resumed] == [4, 4]
    assert resumed[0]["digest"] == resumed[1]["digest"] == straight[0]["digest"]
    assert [r["input_state"] for r in resumed] == states


def test_tensor_parallel_trainer_checkpoint_restores_in_one_process(records):
    res = train(records, "tp", "[1, 2]", 2)
    assert [r["step"] for r in res] == [2, 2] and res[0]["digest"] == res[1]["digest"]
    assert one_process_restore(records, "tp", "[1, 2]", 2) == (2, res[0]["digest"])
