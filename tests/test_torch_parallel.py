"""The port's distribution layer (`ron_tensorflow_tpu_torch/parallel`) on the
CPU: the sharding rules against JAX's, the mesh and its errors, the
collectives' gradients, sync-BN and the global-batch SSD loss on gloo ranks.

Multi-process cases run `tests/torch_dist_workers.py` functions in fresh
processes (`parallel.testing.run_ranks`, each run bounded by its timeout,
each collective by the workers' `TIMEOUT`). Tolerances: the partition specs
and the mesh's groups exactly; sync-BN in float64 within 1e-12 relative of
one process's BatchNorm on the whole batch; the SSD loss in float32 within
1e-6 relative (its shares summed, its gradients row by row).
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.models import get_network as jax_get_network
from ron_tensorflow_tpu.parallel import mesh as jax_mesh
from ron_tensorflow_tpu.train.checkpoint import flatten_params

from ron_tensorflow_tpu_torch.losses.ssd import SsdLossConfig, ssd_losses
from ron_tensorflow_tpu_torch.models import get_network, layers
from ron_tensorflow_tpu_torch.parallel import (
    Mesh,
    initialize_distributed,
    make_mesh,
    partition_batch,
    partition_batch_stats,
    partition_opt_state,
    partition_params,
    process_info,
)
from ron_tensorflow_tpu_torch.parallel.testing import run_ranks
from ron_tensorflow_tpu_torch.weights import jax_names

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
from torch_dist_workers import ssd_inputs  # noqa: E402

RUN_TIMEOUT = 240  # seconds for one multi-process run, start-up included
NETWORKS = ("ron_tiny_vgg", "ron_320_vgg", "ron_320_vgg_heavy", "ssd_300_vgg", "ssd_512_vgg")


def jax_specs(name, mesh):
    """{flax path: PartitionSpec tuple or None} of JAX's params and batch
    stats of `name` on `mesh`."""
    model, spec = jax_get_network(name)
    h, w = spec.img_shape
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), train=False))
    out = {}
    for tree, shard in (("params", jax_mesh.partition_params), ("batch_stats", jax_mesh.partition_batch_stats)):
        if tree in shapes:
            for k, v in flatten_params(shard(shapes[tree], mesh)).items():
                s = tuple(v.spec)
                out[k] = s if any(a is not None for a in s) else None
    return out


@pytest.mark.parametrize("name", NETWORKS)
def test_sharded_tensor_set_equals_jax(name):
    """partition_params / partition_batch_stats on a (4, 2) mesh: the same
    tensors sharded on 'model', on the same (flax-layout) axes, as JAX's on
    make_mesh((4, 2))."""
    want = jax_specs(name, jax_mesh.make_mesh((4, 2)))
    model, _ = get_network(name)
    names = jax_names(model)
    mesh = Mesh((4, 2), rank=0)
    got = {names[k]: v for k, v in {**partition_params(model, mesh), **partition_batch_stats(model, mesh)}.items()}
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if v} == {k: v for k, v in want.items() if v}
    sharded = sorted(k for k, v in got.items() if v)
    if name.startswith("ron"):
        # fc6/fc7, the inception class convs, the objectness and box convs with their BNs
        assert len(sharded) == 2 * 2 + 4 * (4 * 2 + 2 * 5), sharded
        assert all(re.search(r"(fc6|fc7|inception\d_(3x3|1x1)|_objectness/conv|_box/conv)/", k) for k in sharded)
    else:
        assert sharded == []  # SSD's names match none of the rules, in JAX too
    # data parallelism alone shards nothing on 'model'
    assert not any(partition_params(model, Mesh((8, 1), rank=0)).values())


def test_partition_opt_state_and_batch():
    model, _ = get_network("ron_tiny_vgg")
    mesh = Mesh((1, 2), rank=1)
    specs = partition_params(model, mesh)
    opt = {"count": 0, "trace": [torch.zeros(1)] * len(specs)}
    assert partition_opt_state(opt, model, mesh) == {"count": None, "trace": list(specs.values())}
    batch = {"image": torch.zeros(4, 8, 8, 3), "gt_valid": torch.zeros(4, 2, dtype=torch.bool)}
    assert partition_batch(batch, mesh) == {"image": ("data", None, None, None), "gt_valid": ("data", None)}
    assert (mesh.data_index, mesh.model_index) == (0, 1)


def test_make_mesh_in_one_process_and_jax_message():
    mesh = make_mesh()
    assert mesh.shape == (1, 1) and mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError) as port_err:
        make_mesh((2, 1))
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.make_mesh((16, 1))
    assert str(port_err.value) == "mesh shape (2, 1) needs 2 devices, have 1"
    assert str(jax_err.value) == "mesh shape (16, 1) needs 16 devices, have 8"  # the same message


def test_initialize_distributed_does_nothing_for_one_process(monkeypatch):
    """No launcher (no WORLD_SIZE) or one process: nothing is initialized and
    no device is touched (a bare "cuda" device has no index to set)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed(device="cuda") is False
    assert initialize_distributed(num_processes=1, device="cuda") is False
    assert process_info() == (0, 1) and not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="needs num_processes and process_id"):
        initialize_distributed("127.0.0.1:1", device="cpu")


def test_mesh_groups_gather_and_errors_on_four_ranks():
    """Rank r sits at (r // 2, r % 2); its data group is its column, its
    model group its row; gather_channels gathers in rank order and hands
    each rank its own slice of the gradient (not the sum over the group)."""
    res = run_ranks("torch_dist_workers:mesh_worker", 4, timeout=RUN_TIMEOUT, pythonpath=[str(TESTS)])
    for rank, r in enumerate(res):
        d, m = rank // 2, rank % 2
        assert r["coords"] == (d, m)
        assert r["data_ranks"] == [float(m), float(2 + m)]
        assert r["model_ranks"] == [float(2 * d), float(2 * d + 1)]
        assert r["gathered"] == [2.0 * d] * 2 + [2.0 * d + 1] * 2
        assert r["grad"] == [2.0 * m, 2.0 * m + 1]
        assert r["errors"] == ["mesh shape (4, 2) needs 8 devices, have 4",
                               "mesh shape (1, 2) leaves 2 of the 4 ranks out: every rank must be in the mesh"]


def test_sync_batchnorm_on_two_ranks_equals_one_process():
    """BatchNorm in train mode over 2 data ranks (2 rows each): output, the
    input's and the affine parameters' gradients, and the running statistics
    equal one BatchNorm over the 4 rows (float64)."""
    res = run_ranks("torch_dist_workers:sync_bn_worker", 2, timeout=RUN_TIMEOUT, pythonpath=[str(TESTS)])
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(1.0, 2.0, (4, 6, 5, 5))).requires_grad_(True)
    gy = torch.as_tensor(rng.normal(0.0, 1.0, (4, 6, 5, 5)))
    bn = layers.BatchNorm(6).double()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, 6)))
        bn.bias.copy_(torch.as_tensor(rng.normal(0.0, 0.1, 6)))
    y = bn(x, train=True)
    (y * gy).sum().backward()
    close = dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(torch.cat([r["y"] for r in res]), y.detach(), **close)
    torch.testing.assert_close(torch.cat([r["gx"] for r in res]), x.grad, **close)
    for r in res:
        # each rank's parameter gradient is its rows' share; summed over the data group by the step
        torch.testing.assert_close(r["running_mean"], bn.running_mean, **close)
        torch.testing.assert_close(r["running_var"], bn.running_var, **close)
    torch.testing.assert_close(res[0]["gw"] + res[1]["gw"], bn.weight.grad, **close)
    torch.testing.assert_close(res[0]["gb"] + res[1]["gb"], bn.bias.grad, **close)


def test_ssd_loss_on_two_ranks_equals_one_process():
    """The hard-negative threshold is the whole batch's k-th value: the
    shares of 2 ranks sum to the one-process loss, the counts are global,
    the gradients equal row by row. A rank-local threshold gives another
    loss on these inputs (checked), so the test would catch one."""
    res = run_ranks("torch_dist_workers:ssd_loss_worker", 2, timeout=RUN_TIMEOUT, pythonpath=[str(TESTS)])
    logits, locs, labels, glocs, scores = ssd_inputs(0, 4, 300, 21)
    lg, lc = logits.clone().requires_grad_(True), locs.clone().requires_grad_(True)
    total, metrics = ssd_losses(lg, lc, labels, glocs, scores, SsdLossConfig())
    total.backward()
    np.testing.assert_allclose(sum(r["total"] for r in res), float(total.detach()), rtol=1e-6)
    for k in ("loss/ce_pos", "loss/ce_neg", "loss/localization"):
        np.testing.assert_allclose(sum(r["metrics"][k] for r in res), float(metrics[k]), rtol=1e-6)
    assert all(r["metrics"]["counts/positives"] == float(metrics["counts/positives"]) for r in res)
    torch.testing.assert_close(torch.cat([r["g_logits"] for r in res]), lg.grad, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(torch.cat([r["g_locs"] for r in res]), lc.grad, rtol=1e-6, atol=1e-9)
    # what a rank-local threshold (each half its own k-th value) would give instead
    local = sum(float(ssd_losses(logits[i:i + 2], locs[i:i + 2], labels[i:i + 2], glocs[i:i + 2],
                                 scores[i:i + 2], SsdLossConfig())[1]["loss/ce_neg"]) / 2 for i in (0, 2))
    assert abs(local - float(metrics["loss/ce_neg"])) > 1e-3 * float(metrics["loss/ce_neg"])
