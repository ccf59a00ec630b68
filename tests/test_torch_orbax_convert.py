"""tools/orbax_to_npz.py: a JAX model dir's orbax step -> the npz the port
reads (`train.checkpoint.load_orbax_npz`, `weights.from_jax_params`)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ron_tensorflow_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from ron_tensorflow_tpu.train.checkpoint import flatten_params as jax_flatten
from ron_tensorflow_tpu.train.checkpoint import unflatten_params as jax_unflatten
from ron_tensorflow_tpu.train.state import TrainState as JaxTrainState

from ron_tensorflow_tpu_torch.train.checkpoint import load_orbax_npz
from ron_tensorflow_tpu_torch.weights import from_jax_params

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import orbax_to_npz  # noqa: E402

SHAPES = {"backbone/conv1_1/conv/kernel": (3, 3, 3, 8), "backbone/conv1_1/conv/bias": (8,),
          "block4_reverse/deconv_right/deconv_kernel": (2, 2, 8, 8), "block4_reverse/deconv_right/deconv_bias": (8,),
          "block4_box/conv/bn/scale": (8,), "block4_box/conv/bn/bias": (8,)}
STATS = {"block4_box/conv/bn/mean": (8,), "block4_box/conv/bn/var": (8,)}


def seeded(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("ema", [True, False], ids=["with_ema", "without_ema"])
def test_converter_keeps_names_and_values(ema, tmp_path):
    params, stats = seeded(SHAPES, 0), seeded(STATS, 1)
    ema_params = {k: v * 0.5 for k, v in params.items()} if ema else None
    tree = lambda d: jax_unflatten({k: jnp.asarray(v) for k, v in d.items()})  # noqa: E731
    state = JaxTrainState(step=jnp.asarray(12, jnp.int32), params=tree(params), batch_stats=tree(stats),
                          opt_state={"trace": tree(params)}, ema_params=tree(ema_params) if ema else None)
    mgr = JaxCheckpointManager(str(tmp_path / "model"))
    for step in (5, 12):
        mgr.save(step, jax.device_get(state))
    mgr.wait()
    out = tmp_path / "state.npz"
    assert orbax_to_npz.main([str(tmp_path / "model"), str(out)]) == 0
    with np.load(out) as f:
        assert sorted(f.files) == sorted(["step", *(f"params/{k}" for k in params), *(f"batch_stats/{k}" for k in stats),
                                          *((f"ema_params/{k}" for k in params) if ema else ())])
    got = load_orbax_npz(str(out))
    assert got["step"] == 12
    for part, want in (("params", params), ("batch_stats", stats), ("ema_params", ema_params)):
        if want is None:
            assert got[part] is None
            continue
        assert got[part].keys() == want.keys()
        for k, v in want.items():
            assert got[part][k].dtype == v.dtype and np.array_equal(got[part][k], v), (part, k)
    # the port takes the npz's names and layouts as they are
    sd = from_jax_params(got["params"], got["batch_stats"])
    assert torch.equal(sd["block4_reverse.deconv_right.weight"],
                       torch.from_numpy(params["block4_reverse/deconv_right/deconv_kernel"]).flip(0, 1).permute(2, 3, 0, 1))
    assert sd["block4_box.conv.bn.running_var"].tolist() == stats["block4_box/conv/bn/var"].tolist()
    assert orbax_to_npz.main([str(tmp_path / "model"), str(out), "--step", "5"]) == 0
    assert load_orbax_npz(str(out))["step"] == 5


@pytest.mark.slow
@pytest.mark.parametrize("use_ema", [False, True])
def test_tiny_ron_state_round_trip_forward_equals_jax(use_ema, tmp_path):
    """A JAX tiny-RON TrainState (flax init, an EMA unlike the parameters)
    through orbax and the converter into the port: the port's forward on
    the converted weights equals JAX's within 1e-5 of each output's largest
    magnitude."""
    import optax

    from ron_tensorflow_tpu.models import get_network as jax_network
    from ron_tensorflow_tpu.train.state import create_train_state

    from ron_tensorflow_tpu_torch.models import get_network

    jmodel, spec = jax_network("ron_tiny_vgg")
    state = create_train_state(jmodel, jax.random.PRNGKey(3), (1, *spec.img_shape, 3), optax.sgd(0.1), ema=True)
    rng = np.random.default_rng(4)
    stats = jax.tree.map(lambda x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(np.float32)), state.batch_stats)
    ema = jax.tree.map(lambda x: x * 0.75 + 0.01, state.params)
    state = state.replace(batch_stats=stats, ema_params=ema)
    mgr = JaxCheckpointManager(str(tmp_path / "model"))
    mgr.save(0, jax.device_get(state))
    mgr.wait()
    assert orbax_to_npz.main([str(tmp_path / "model"), str(tmp_path / "s.npz")]) == 0
    got = load_orbax_npz(str(tmp_path / "s.npz"))
    model, _ = get_network("ron_tiny_vgg")
    model.load_state_dict(from_jax_params(got["ema_params"] if use_ema else got["params"], got["batch_stats"]),
                          strict=True)
    x = np.random.default_rng(5).standard_normal((2, *spec.img_shape, 3)).astype(np.float32)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    variables = {"params": ema if use_ema else state.params, "batch_stats": stats}
    with jax.default_matmul_precision("highest"):
        theirs = jmodel.apply(variables, jnp.asarray(x), train=False)
    for field in ("logits", "locations", "objness_logits", "predictions", "objness_pred"):
        ref = np.asarray(getattr(theirs, field))
        err = np.abs(getattr(ours, field).numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (field, err)
    assert len(jax_flatten(ema)) == len(got["params"])
