"""The port's distributed train step on the CPU (gloo ranks) against its
one-process step on the same global batch, and against JAX's step on
`make_mesh((2, 1))`.

Slow (each 35-80 s beside the other test workers, 2-4 processes of ~2.6 GB
each): every case but the (2, 1) RON step, and the JAX case.

Each case runs the tiny RON (RON-320's widths) on a (data, model) mesh of
2 or 4 ranks (`tests/torch_dist_workers.py::train_step_worker`, each run
bounded by `RUN_TIMEOUT`), with global-norm clipping on (the gradient norm
is ~35, the clip 1), the RON or the SSD loss, momentum, weight decay and an
EMA: the loss parts, the counts and `grad_norm` of each step within 1e-5
relative of the one-process step's; parameters, BatchNorm statistics and
EMA within 1e-5 of each tensor's largest magnitude; the gathered state
bit-identical on every rank. One step runs in float32; two steps (the
second one reads the sharded momentum) run the model in float64: after one
float32 step the two runs' parameters differ by ~5e-8 (the convolutions see
batches of other sizes), and the second step's ReLU flips, amplified by
train-mode BatchNorm over few values, part their grad_norm by 1e-5 (RON) to
2e-4 (SSD), as two float32 runs of JAX alone part (tests/test_torch_train.py).
The JAX case holds the (2, 1) step to JAX's
`make_train_step` jitted over `make_mesh((2, 1))` with
`tests/test_torch_train.py`'s tolerances (float32 on both sides: losses
1e-4, grad_norm 1e-3, state 1e-5 of each tensor's largest magnitude).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ron_tensorflow_tpu.losses.ron import RonLossConfig as JaxRonLossConfig
from ron_tensorflow_tpu.parallel import mesh as jax_mesh
from ron_tensorflow_tpu.train import state as jax_state
from ron_tensorflow_tpu.train.checkpoint import flatten_params

from ron_tensorflow_tpu_torch.models import get_network
from ron_tensorflow_tpu_torch.models.testing import seeded_flax_params
from ron_tensorflow_tpu_torch.parallel.testing import run_ranks
from ron_tensorflow_tpu_torch.weights import from_jax_params, to_jax_params

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
from test_torch_train import GRAD_NORM_RTOL, METRIC_RTOL, assert_tree_close, jax_setup, loss_draws  # noqa: E402
from torch_dist_workers import EMA, tiny_batch  # noqa: E402

TOL = 1e-5
RUN_TIMEOUT = 300  # seconds for one multi-process run: 2-4 ranks and rank 0's one-process reference
CLIP = 1.0


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded flax-named weights of the tiny RON, and the port's state_dict
    of them in a file the ranks load."""
    model, _ = get_network("ron_tiny_vgg")
    params, stats = seeded_flax_params(model, 4)
    path = tmp_path_factory.mktemp("dist_step") / "weights.pt"
    torch.save(from_jax_params(params, stats), path)
    yield params, stats, str(path)
    path.unlink()


def run_step(weights, mesh_shape, loss, steps=1, clip=CLIP, **kw):
    world = mesh_shape[0] * mesh_shape[1]
    return run_ranks("torch_dist_workers:train_step_worker", world,
                     dict(weights=weights, mesh_shape=mesh_shape, loss=loss, steps=steps, clip=clip, **kw),
                     timeout=RUN_TIMEOUT, pythonpath=[str(TESTS)])


@pytest.mark.parametrize("mesh_shape,loss,steps", [
    ((2, 1), "ron", 1),
    pytest.param((1, 2), "ssd", 1, marks=pytest.mark.slow),
    pytest.param((2, 2), "ssd", 1, marks=pytest.mark.slow),
    pytest.param((2, 1), "ssd", 1, marks=pytest.mark.slow),
    pytest.param((1, 2), "ron", 2, marks=pytest.mark.slow),
    pytest.param((2, 2), "ron", 2, marks=pytest.mark.slow),
])
def test_distributed_step_equals_one_process_step(weights, mesh_shape, loss, steps):
    res = run_step(weights[2], mesh_shape, loss, steps, dtype="float32" if steps == 1 else "float64")
    r0 = res[0]
    assert len({r["digest"] for r in res}) == 1, "ranks hold different states"
    assert all(r["metrics"] == r0["metrics"] for r in res), "ranks report different metrics"
    assert len(r0["metrics"]) == steps
    for i, (got, ref) in enumerate(zip(r0["metrics"], r0["ref_metrics"])):
        assert got.keys() == ref.keys()
        assert ref["grad_norm"] > CLIP and ref["counts/positives"] > 0  # clipping on, positives present
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=TOL, err_msg=f"step {i} {k}")
    for part, errors in r0["state_errors"].items():
        worst = max(errors, key=errors.get)
        assert errors[worst] <= TOL, (part, worst, errors[worst])
    # what the mesh shards on 'model': JAX's rules (76 tensors of the tiny RON), nothing on 'data' alone
    assert len(r0["sharded"]) == (76 if mesh_shape[1] > 1 else 0)


@pytest.mark.slow
def test_data_parallel_step_matches_jax_mesh_step(weights, tmp_path):
    """The port's step on 2 gloo ranks against JAX's `make_train_step`
    jitted over `make_mesh((2, 1))` (a batch sharded on 'data'), on the same
    weights, batch and loss draws (JAX's own, made for the global batch)."""
    params, stats, path = weights
    batch = tiny_batch(seed=0, b=4)
    n = get_network("ron_tiny_vgg")[1].anchor_layout().num_anchors
    rng = jax.random.PRNGKey(10)
    draws_file = tmp_path / "draws.pt"
    torch.save([loss_draws(rng, (4, n))], draws_file)

    jmodel, jenc, jtx, jst = jax_setup(params, stats)
    mesh = jax_mesh.make_mesh((2, 1))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rep = jax.tree.map(lambda _: NamedSharding(mesh, P()), jst)
    bsh = jax_mesh.partition_batch(jbatch, mesh)
    step = jax.jit(jax_state.make_train_step(jmodel, jenc, jtx, JaxRonLossConfig(), EMA),
                   in_shardings=(rep, bsh, NamedSharding(mesh, P())))
    jst, ref = step(jax.device_put(jst, rep), jax.device_put(jbatch, bsh), rng)

    res = run_step(path, (2, 1), "ron", clip=0.0, draws_file=str(draws_file), return_state=True)  # JAX's OPT: no clip
    got, whole = res[0]["metrics"][0], res[0]["state"]
    for k in ref:
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else METRIC_RTOL
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=rtol, err_msg=k)
    model, _ = get_network("ron_tiny_vgg")
    assert_tree_close(to_jax_params(model, whole["params"].items()), flatten_params(jst.params), "params")
    assert_tree_close(to_jax_params(model, whole["batch_stats"].items()), flatten_params(jst.batch_stats),
                      "batch stats")
    assert_tree_close(to_jax_params(model, whole["ema_params"].items()), flatten_params(jst.ema_params), "EMA")
