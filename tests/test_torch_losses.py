"""The port's RON loss against the JAX package's, on the CPU, with JAX's own
negative-sampling draws handed to the port.

Tolerances: the loss, its components and counts within 1e-6 relative (both
sides sum the same float32 terms, in another order); each gradient within
1e-5 of its largest magnitude (and 1e-5 relative) of `jax.grad`'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.losses.ron import RonLossConfig as JaxRonLossConfig
from ron_tensorflow_tpu.losses.ron import ron_losses as jax_ron_losses
from ron_tensorflow_tpu.ops import math as jax_math

from ron_tensorflow_tpu_torch.losses.ron import RonLossConfig, draw_uniforms, ron_losses
from ron_tensorflow_tpu_torch.models.spec import RON_320_SPEC, RON_TINY_SPEC
from ron_tensorflow_tpu_torch.ops import math as port_math
from ron_tensorflow_tpu_torch.ops.encode import TargetEncoder
from test_torch_encode import crowded_scene

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: its CPU steps share the
    cores with the other test workers, and eight spinning threads a worker
    slow all of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_draws(rng, shape):
    """The two uniforms `ron_losses` draws from `rng` (losses/ron.py:90,101,112)."""
    k_obj, k_cls = jax.random.split(rng)
    return np.stack([np.asarray(jax.random.uniform(k, shape, jnp.float32)) for k in (k_obj, k_cls)])


def make_case(kind, seed=0):
    """(inputs as numpy: logits, locations, objness_logits, objness_pred,
    gclasses, glocations; loss config) for one test case."""
    rng = np.random.default_rng(seed)
    spec = RON_320_SPEC if kind == "crowded, RON-320" else RON_TINY_SPEC
    enc = TargetEncoder(spec.anchor_layout(), spec.img_shape, 0.56 if spec is RON_320_SPEC else 0.5, 0.3)
    scenes = [crowded_scene(rng, 48 if "crowded" in kind else 4) for _ in range(2)]
    labels, boxes, valid = (np.stack(a) for a in zip(*scenes))
    if kind == "zero positives":
        valid[:] = False
    t = enc.batched(labels, boxes, valid)
    gclasses, glocations = t.labels.numpy(), t.locations.numpy()
    if kind == "ignore excluded":  # a third of the anchors ignored, positives among them
        gclasses = np.where(rng.uniform(size=gclasses.shape) < 0.33, -1, gclasses)
    b, n = gclasses.shape
    logits = rng.normal(0, 2, (b, n, 21)).astype(np.float32)
    locations = rng.normal(0, 1, (b, n, 4)).astype(np.float32)
    objness_logits = rng.normal(0, 2, (b, n, 2)).astype(np.float32)
    if kind == "no gated positives":  # P(object) below the 0.03 gate everywhere
        objness_logits[..., 1] -= 12.0
    pred = np.array(jax.nn.softmax(jnp.asarray(objness_logits), axis=-1)[..., 1])
    cfg = dict(num_classes=21)
    if kind == "saturated sampling":  # more wanted negatives than there are
        cfg["negative_ratio"] = 1e4
    return (logits, locations, objness_logits, pred, gclasses, glocations), cfg


CASES = ["tiny", "crowded, tiny", "crowded, RON-320", "zero positives", "ignore excluded", "no gated positives",
         "saturated sampling"]


@pytest.mark.parametrize("kind", CASES)
def test_ron_losses_match_jax_with_injected_draws(kind):
    inputs, cfg = make_case(kind)
    logits, locations, objness_logits, pred, gclasses, glocations = inputs
    rng = jax.random.PRNGKey(CASES.index(kind))
    jcfg = JaxRonLossConfig(**cfg)

    def jax_total(lg, loc, ol):
        return jax_ron_losses(rng, lg, loc, ol, jnp.asarray(pred), jnp.asarray(gclasses), jnp.asarray(glocations),
                              jcfg)

    (ref_total, ref_metrics), ref_grads = jax.value_and_grad(jax_total, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(locations), jnp.asarray(objness_logits))

    leaves = [torch.tensor(a, requires_grad=True) for a in (logits, locations, objness_logits)]
    draws = torch.as_tensor(jax_draws(rng, gclasses.shape))
    total, metrics = ron_losses(*leaves, torch.as_tensor(pred), torch.as_tensor(gclasses),
                                torch.as_tensor(glocations), RonLossConfig(**cfg), draws=draws)
    total.backward()

    assert metrics.keys() == ref_metrics.keys()
    for key, ref in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[key].detach()), float(ref), rtol=LOSS_RTOL, atol=0, err_msg=key)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=LOSS_RTOL, atol=0)
    for name, leaf, ref in zip(("logits", "locations", "objness_logits"), leaves, ref_grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=GRAD_TOL, atol=GRAD_TOL * float(np.abs(ref).max()),
                                   err_msg=name)
    n_pos = float(ref_metrics["counts/positives"])
    if kind == "zero positives":
        assert n_pos == 0 and float(total) == 0.0 and all(float(np.abs(g).max()) == 0 for g in ref_grads)
    else:
        assert n_pos > 0 and float(total) > 0
    if kind == "no gated positives":
        assert float(metrics["counts/cls_positives"]) == 0 and float(metrics["loss/localization"]) == 0


def test_ignored_anchors_take_no_gradient():
    inputs, cfg = make_case("ignore excluded", seed=3)
    logits, locations, objness_logits, pred, gclasses, glocations = inputs
    leaves = [torch.tensor(a, requires_grad=True) for a in (logits, locations, objness_logits)]
    total, _ = ron_losses(*leaves, torch.as_tensor(pred), torch.as_tensor(gclasses), torch.as_tensor(glocations),
                          RonLossConfig(**cfg), generator=torch.Generator().manual_seed(0))
    total.backward()
    ignored = torch.as_tensor(gclasses) == -1
    assert ignored.any()
    for leaf in leaves:
        assert float(leaf.grad[ignored].abs().max()) == 0.0


def test_generator_draws_are_reproducible():
    inputs, cfg = make_case("tiny", seed=4)
    tensors = [torch.as_tensor(a) for a in inputs]
    run = lambda seed: ron_losses(*tensors, generator=torch.Generator().manual_seed(seed))[0]  # noqa: E731
    assert float(run(1)) == float(run(1))
    draws = draw_uniforms((2, 7), torch.Generator().manual_seed(0))
    assert draws.shape == (2, 2, 7) and float(draws.min()) >= 0 and float(draws.max()) < 1


@pytest.mark.parametrize("fn", ["smooth_l1", "abs_smooth", "safe_divide", "softmax_ce"])
def test_math_terms_match_jax(fn):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (64, 21)).astype(np.float32)
    x[0, :4] = (0.0, 1.0 / 9.0, -1.0 / 9.0, 1.0)  # the branch points
    if fn == "smooth_l1":
        got, ref = port_math.smooth_l1(torch.as_tensor(x), 3.0), jax_math.smooth_l1(jnp.asarray(x), 3.0)
    elif fn == "abs_smooth":
        got, ref = port_math.abs_smooth(torch.as_tensor(x)), jax_math.abs_smooth(jnp.asarray(x))
    elif fn == "safe_divide":
        den = np.where(rng.uniform(size=x.shape) < 0.3, 0.0, x).astype(np.float32)
        got = port_math.safe_divide(torch.as_tensor(x), torch.as_tensor(den))
        ref = jax_math.safe_divide(jnp.asarray(x), jnp.asarray(den))
    else:
        labels = rng.integers(0, 21, 64)
        got = port_math.softmax_ce(torch.as_tensor(x), torch.as_tensor(labels))
        ref = jax_math.softmax_ce(jnp.asarray(x), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
