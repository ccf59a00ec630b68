"""One SSD-300 train step of the port against JAX's `make_train_step`, on
the CPU: the same numpy-made weights and batch, `SsdLossConfig`, dropout
rate 0 (the masks are the only draws of an SSD step, and the two
frameworks' generators give different bits).

JAX's gradients come from `jax.grad` of the step's own loss function (the
model in train mode, the encoder, `ssd_losses`), the port's from hooks on
its parameters during the step.

Tolerances (float32 on both sides, sums in another order): the losses and
the positive count within 1e-4 relative, grad_norm within 1e-4. The
gradients, and the updates (new - old parameters; momentum, weight decay):
the median over the tensors of max |port - JAX| / max |JAX| within 1e-4,
each tensor within 1e-2. A step is not continuous
at its ReLUs: on this batch one pre-activation of block8's 1x1 conv is
-2.0e-6 in float64 and +1.3e-6 in the port's float32, and that one flip
moves block8.conv1x1's kernel gradient by 0.57% of its largest magnitude
(JAX's float32 lies 7.7e-7 from float64 there, but 0.30% in conv1_1's
kernel, where the port lies 0.28%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.losses.ssd import SsdLossConfig as JaxSsdLossConfig
from ron_tensorflow_tpu.losses.ssd import ssd_losses as jax_ssd_losses
from ron_tensorflow_tpu.models import ssd as jax_ssd
from ron_tensorflow_tpu.ops.encode import TargetEncoder as JaxTargetEncoder
from ron_tensorflow_tpu.train import optimizer as jax_opt
from ron_tensorflow_tpu.train import state as jax_state
from ron_tensorflow_tpu.train.checkpoint import flatten_params, unflatten_params

from ron_tensorflow_tpu_torch.losses.ssd import SsdLossConfig
from ron_tensorflow_tpu_torch.models import get_network
from ron_tensorflow_tpu_torch.models.testing import seeded_flax_params
from ron_tensorflow_tpu_torch.ops.encode import TargetEncoder
from ron_tensorflow_tpu_torch.train import optimizer as port_opt
from ron_tensorflow_tpu_torch.train.state import create_train_state, make_train_step
from ron_tensorflow_tpu_torch.weights import from_jax_params, to_jax_params

METRIC_RTOL = 1e-4
GRAD_MEDIAN_TOL, GRAD_TOL = 1e-4, 1e-2
OPT = dict(optimizer="momentum", learning_rate=1e-3, learning_rate_decay_type="fixed", weight_decay=5e-4)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_ssd300_train_step_matches_jax():
    model, spec = get_network("ssd_300_vgg", dropout_rate=0.0)
    params, _ = seeded_flax_params(model, seed=41)
    model.load_state_dict(from_jax_params(params, {}), strict=True)
    rng = np.random.default_rng(42)
    batch = {
        "image": (rng.uniform(0, 255, (2, 300, 300, 3)) - 120).astype(np.float32),
        "gt_labels": np.array([[3, 12, 0], [7, 15, 0]], np.int32),
        "gt_boxes": np.array([[[0.1, 0.1, 0.6, 0.5], [0.3, 0.4, 0.9, 0.95], [0, 0, 0, 0]],
                              [[0.2, 0.05, 0.45, 0.3], [0.5, 0.5, 0.8, 0.7], [0, 0, 0, 0]]], np.float32),
        "gt_valid": np.array([[True, True, False], [True, True, False]]),
    }
    # JAX
    jmodel = jax_ssd.SSD(spec=jax_ssd.SSD_300_SPEC, dropout_rate=0.0)
    jenc = JaxTargetEncoder(jax_ssd.SSD_300_SPEC.anchor_layout(), (300, 300), 0.5, 0.5)
    jtx = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT))
    p = jax.tree.map(jnp.asarray, unflatten_params(params))
    jst = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=p, batch_stats={}, opt_state=jtx.init(p))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):  # make_train_step's loss (state.py:119-129) without the mutable batch stats
        out = jmodel.apply({"params": p}, jbatch["image"], train=True, rngs={"dropout": jax.random.PRNGKey(1)})
        t = jenc.batched(jbatch["gt_labels"], jbatch["gt_boxes"], jbatch["gt_valid"])
        return jax_ssd_losses(out.logits, out.locations, t.labels, t.locations, t.scores)[0]

    with jax.default_matmul_precision("highest"):
        jst, ref = jax.jit(jax_state.make_train_step(jmodel, jenc, jtx, JaxSsdLossConfig()))(
            jst, jbatch, jax.random.PRNGKey(0))
        ref_grads = flatten_params(jax.jit(jax.grad(loss_fn))(p))
    # the port
    enc = TargetEncoder(spec.anchor_layout(), spec.img_shape, 0.5, 0.5)
    tx = port_opt.make_optimizer(port_opt.OptimizerConfig(**OPT), model)
    st = create_train_state(model, tx)
    grads = {}

    def keep(name):
        def hook(g):  # records the gradient and leaves it alone
            grads.setdefault(name, g.detach().clone())
        return hook

    for name, t in model.named_parameters():
        t.register_hook(keep(name))
    step = make_train_step(model, enc, tx, SsdLossConfig())
    st, got = step(st, {k: torch.as_tensor(v) for k, v in batch.items()}, generator=torch.Generator().manual_seed(0))
    assert got.keys() == ref.keys() and st.step == 1
    assert float(got["counts/positives"]) == float(ref["counts/positives"]) > 0
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=METRIC_RTOL, err_msg=k)
    got_grads = to_jax_params(model, grads.items())
    assert got_grads.keys() == ref_grads.keys() == params.keys()
    new_got, new_ref = to_jax_params(model, model.named_parameters()), flatten_params(jst.params)
    updates = ({k: new_got[k] - params[k] for k in params}, {k: np.asarray(new_ref[k]) - params[k] for k in params})
    for label, (got_t, ref_t) in {"gradients": (got_grads, ref_grads), "updates": updates}.items():
        worst = {}
        for k, r in ref_t.items():
            r = np.asarray(r)
            worst[k] = float(np.abs(got_t[k] - r).max()) / max(float(np.abs(r).max()), 1e-30)
        assert float(np.median(list(worst.values()))) <= GRAD_MEDIAN_TOL, label
        assert max(worst.values()) <= GRAD_TOL, (label, sorted(worst.items(), key=lambda kv: -kv[1])[:3])
