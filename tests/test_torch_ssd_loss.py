"""The port's SSD loss (hard negative mining) against the JAX package's, on
the CPU: `ssd_losses` values and gradients on small rows at the mining
rule's edges, the SSD branch of `detection_loss_fn` on encoded targets, and
`make_eval_step` with `SsdLossConfig` on SSD-300.

Tolerances: the mining selects the same anchors (counts equal); the loss
terms within 1e-5 relative and their gradients within 1e-5 of each
gradient's largest magnitude (float32 softmax and sums in another order).
On SSD-300 (a whole forward) the losses within 1e-4 relative.
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
from ron_tensorflow_tpu.train import state as jax_state
from ron_tensorflow_tpu.train.checkpoint import unflatten_params

from ron_tensorflow_tpu_torch.losses.ssd import SsdLossConfig, ssd_losses
from ron_tensorflow_tpu_torch.models import get_network
from ron_tensorflow_tpu_torch.models.testing import seeded_flax_params
from ron_tensorflow_tpu_torch.ops.encode import TargetEncoder
from ron_tensorflow_tpu_torch.train.state import create_train_state, detection_loss_fn, make_eval_step
from ron_tensorflow_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from ron_tensorflow_tpu_torch.weights import from_jax_params

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
MODEL_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def loss_case(kind, seed=0, b=2, n=40, c=5):
    """logits [B, N, C], locations, gclasses, glocations, gscores for one
    edge of the mining rule."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (b, n, c)).astype(np.float32)
    locs = rng.normal(0, 1, (b, n, 4)).astype(np.float32)
    glocs = rng.normal(0, 1, (b, n, 4)).astype(np.float32)
    scores = rng.uniform(-1, 1, (b, n)).astype(np.float32)  # > 0.5 positive, <= -0.5 ignored
    if kind == "no positives":  # n_neg = B
        scores = np.minimum(scores, 0.5)
    elif kind == "ties at the k-th value":
        # 3 positives -> n_neg = int(3 * 3) + 2 = 11; anchors 0..19 of image 1
        # share one logits row, so the 11th smallest background probability
        # is tied 20 ways and no tied one is taken
        scores[:] = 0.0
        scores[0, :3] = 0.9
        logits[1, :20] = logits[1, 0]
        logits[1, 20:, 0] = 8.0  # the rest have a larger background probability
        logits[0, 3:, 0] = 8.0
    elif kind == "more wanted than candidates":  # n_neg > max_neg_entries
        scores[:] = 0.9
        scores[0, :4] = 0.1
        scores[1, :2] = -0.7
    elif kind == "all ignored":  # no candidate: n_neg = 0, nothing taken
        scores[:] = -0.9
        scores[0, 0] = 0.9
    labels = np.where(scores > 0.5, rng.integers(1, c, (b, n)), 0).astype(np.int32)
    return logits, locs, labels, glocs, scores


def run_both(case, cfg_kw):
    logits, locs, labels, glocs, scores = case
    jcfg, cfg = JaxSsdLossConfig(**cfg_kw), SsdLossConfig(**cfg_kw)

    def jloss(lg, lc):
        return jax_ssd_losses(lg, lc, jnp.asarray(labels), jnp.asarray(glocs), jnp.asarray(scores), jcfg)

    (ref_total, ref_m), ref_g = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(locs))
    lg, lc = (torch.tensor(a, requires_grad=True) for a in (logits, locs))
    total, m = ssd_losses(lg, lc, *(torch.as_tensor(a) for a in (labels, glocs, scores)), cfg)
    total.backward()
    return (ref_m, ref_g), (m, (lg.grad, lc.grad))


@pytest.mark.parametrize("kind", ["random", "no positives", "ties at the k-th value", "more wanted than candidates",
                                  "all ignored"])
def test_ssd_losses_and_gradients_match_jax(kind):
    case = loss_case(kind)
    (ref_m, ref_g), (m, g) = run_both(case, dict(num_classes=5))
    assert m.keys() == ref_m.keys()
    for k in ref_m:
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for name, got, ref in zip(("logits", "locations"), g, ref_g):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=GRAD_TOL * max(float(np.abs(ref).max()), 1e-30),
                                   err_msg=name)
    # the mining's count of negatives: rows whose ce_neg gradient is not 0
    logits = case[0]
    neg_rows = (np.abs(np.asarray(ref_g[0])).sum(-1) > 0) & (case[4] <= 0.5)
    n_pos = int((case[4] > 0.5).sum())
    if kind == "no positives":
        assert n_pos == 0 and float(m["loss/ce_pos"]) == 0 and int(neg_rows.sum()) == 2 - 1  # the k-th is left out
    elif kind == "ties at the k-th value":
        assert int(neg_rows.sum()) == 0 and float(m["loss/ce_neg"]) == 0  # all 11 wanted lie in the 20-way tie
        assert logits.shape == (2, 40, 5)
    elif kind == "more wanted than candidates":
        # n_neg clipped to the 4 candidates: the 4th smallest is the k-th, so 3 are taken
        assert int(neg_rows.sum()) == 3
    elif kind == "all ignored":
        assert int(neg_rows.sum()) == 0 and float(m["loss/ce_neg"]) == 0


def test_ssd_losses_alpha_and_threshold():
    case = loss_case("random", seed=3)
    (ref_m, _), (m, _) = run_both(case, dict(num_classes=5, match_threshold=0.3, negative_ratio=2.0, alpha=0.5))
    for k in ref_m:
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


# --------------------------------------------------------------------------- #
# on SSD-300


@pytest.fixture(scope="module")
def ssd300():
    model, spec = get_network("ssd_300_vgg")
    params, _ = seeded_flax_params(model, seed=31)
    model.load_state_dict(from_jax_params(params, {}), strict=True)
    rng = np.random.default_rng(32)
    images = (rng.uniform(0, 255, (2, 300, 300, 3)) - 120).astype(np.float32)
    boxes = np.array([[[0.1, 0.1, 0.6, 0.5], [0.3, 0.4, 0.9, 0.95], [0, 0, 0, 0]],
                      [[0.2, 0.05, 0.45, 0.3], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    batch = {"image": images, "gt_labels": np.array([[3, 12, 0], [7, 0, 0]], np.int32), "gt_boxes": boxes,
             "gt_valid": np.array([[True, True, False], [True, False, False]])}
    return params, model, spec, batch


def test_detection_loss_fn_ssd_branch_matches_jax(ssd300):
    """The SSD branch of detection_loss_fn on the encoded targets of
    SSD-300's outputs (8 732 anchors), and its draws: none."""
    params, model, spec, batch = ssd300
    jenc = JaxTargetEncoder(jax_ssd.SSD_300_SPEC.anchor_layout(), (300, 300), 0.5, 0.5)
    enc = TargetEncoder(spec.anchor_layout(), spec.img_shape, 0.5, 0.5)
    with jax.default_matmul_precision("highest"):
        jout = jax_ssd.SSD(spec=jax_ssd.SSD_300_SPEC).apply(
            {"params": jax.tree.map(jnp.asarray, unflatten_params(params))}, jnp.asarray(batch["image"]))
    jt = jenc.batched(*(jnp.asarray(batch[k]) for k in ("gt_labels", "gt_boxes", "gt_valid")))
    _, ref = jax_state.detection_loss_fn(JaxSsdLossConfig())(jax.random.PRNGKey(0), jout, jt)
    with torch.no_grad():
        out = model(torch.as_tensor(batch["image"]))
    t = enc.batched(*(torch.as_tensor(batch[k]) for k in ("gt_labels", "gt_boxes", "gt_valid")))
    fn = detection_loss_fn(SsdLossConfig())
    _, got = fn(out, t)
    _, again = fn(out, t, torch.Generator().manual_seed(5), None)  # the generator is not drawn from
    assert float(got["counts/positives"]) == float(ref["counts/positives"]) > 0
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=MODEL_RTOL, err_msg=k)
        assert float(again[k]) == float(got[k])


def test_ssd_eval_step_matches_jax(ssd300):
    params, model, spec, batch = ssd300
    jmodel = jax_ssd.SSD(spec=jax_ssd.SSD_300_SPEC)
    jenc = JaxTargetEncoder(jax_ssd.SSD_300_SPEC.anchor_layout(), (300, 300), 0.5, 0.3)
    jst = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, unflatten_params(params)),
                               batch_stats={}, opt_state=None)
    with jax.default_matmul_precision("highest"):
        _, ref = jax_state.make_eval_step(jmodel, jenc, JaxSsdLossConfig())(
            jst, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    enc = TargetEncoder(spec.anchor_layout(), spec.img_shape, 0.5, 0.3)
    st = create_train_state(model, make_optimizer(OptimizerConfig(), model))
    _, got = make_eval_step(model, enc, SsdLossConfig())(st, {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=MODEL_RTOL, err_msg=k)
