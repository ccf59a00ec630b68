"""The port's overfit check (`ron_tensorflow_tpu_torch/tools/overfit_check.py`)
against JAX's (`tools/overfit_check.py`, loaded by path), on the CPU.

JAX's tool is run up to its first train step, where a stand-in for the
step records what the tool built (its batch, its `create_train_state`
state, its optimizer) and stops it. Then:
- the port's 8 images and gts equal the JAX tool's bit for bit;
- the port's loop (`overfit_check.train`, the port's optimizer and train
  step) from JAX's initial parameters and statistics, carried across, with
  JAX's loss draws of `PRNGKey(i)`, against JAX's `make_train_step` jitted
  on the same batch, within tests/test_torch_train.py's tolerances (metrics
  1e-4 relative, grad_norm 1e-3; parameters and statistics within 1e-5 of
  each tensor's largest magnitude; the update within 1e-2 in L2): three
  steps at that file's lr of 1e-5, and one step with the tool's optimizer
  (lr 2e-3), whose metrics, statistics and update are held but not each
  parameter: at that lr the first step moves conv1_1's kernel by ~3e-6
  more or less than JAX's, 2.7e-5 of its largest magnitude (its gradient,
  a sum of 32768 terms that cancel, parts by ~1% between the two). flax
  initializes biases and BatchNorm offsets at 0: those tensors hold only
  their updates, held to the L2 bound with the rest. At lr 2e-3 the second
  step's grad_norm already lies 0.77% from
  JAX's: a RON step is discontinuous at its ReLUs and the train-mode
  BatchNorms amplify a flip (tests/test_torch_train.py's docstring);
- `--device cpu --steps 2` runs the whole check and prints its lines.

Under `-m slow` (~20 min): JAX's 400 steps from its own init, then its
trained weights through the port's evaluation give JAX's per-class APs
(1.0 each, measured); and the port's 400 steps from the same init with
JAX's loss draws pass the tool's 0.8 (measured: AP 1.0 on each class, as
JAX's). The port's own init and draws (seed 0) reach 0.88-0.89 instead:
class 1 lags, from the draws and not the loop.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.losses.ron import RonLossConfig as JaxRonLossConfig
from ron_tensorflow_tpu.models.ron import RON as JaxRON
from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.ops.encode import TargetEncoder as JaxTargetEncoder
from ron_tensorflow_tpu.train import optimizer as jax_opt
from ron_tensorflow_tpu.train import state as jax_state
from ron_tensorflow_tpu.train.checkpoint import flatten_params

from ron_tensorflow_tpu_torch.tools import overfit_check
from ron_tensorflow_tpu_torch.weights import from_jax_params, to_jax_params

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
from test_torch_train import GRAD_NORM_RTOL, METRIC_RTOL, UPDATE_TOL, assert_tree_close, loss_draws  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def jax_tool_setup():
    """What JAX's tool builds before its first step: its batch, initial
    state and optimizer."""
    spec = importlib.util.spec_from_file_location("jax_overfit_check", TESTS.parent / "tools" / "overfit_check.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    seen = {}
    real_make, real_jit = jax_state.make_train_step, jax.jit

    def step(state, batch, rng):
        seen.update(state=state, batch=batch)
        raise _Stop

    def make_train_step(model, encoder, tx, loss_config):
        seen["tx"] = tx
        return step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("ron_tensorflow_tpu.train.make_train_step", make_train_step)
        mp.setattr(jax, "jit", lambda fn, *a, **k: fn if fn is step else real_jit(fn, *a, **k))
        with pytest.raises(_Stop):
            tool.main()
    assert jax_state.make_train_step is real_make
    return seen


def test_data_equal_jax_tool(jax_tool_setup):
    got, ref = overfit_check.overfit_data(), jax_tool_setup["batch"]
    for key in ("image", "gt_labels", "gt_boxes", "gt_valid"):
        assert got[key].dtype == np.asarray(ref[key]).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("steps, lr", [(1, None), (3, 1e-5)], ids=["one step at the tool's lr", "three at 1e-5"])
def test_steps_of_the_loop_match_jax(jax_tool_setup, steps, lr):
    jst, tx, batch = jax_tool_setup["state"], jax_tool_setup["tx"], jax_tool_setup["batch"]
    optimizer = overfit_check.OPTIMIZER
    if lr is not None:
        optimizer = dataclasses.replace(optimizer, learning_rate=lr)
        tx = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**dataclasses.asdict(optimizer)))
        jst = jst.replace(opt_state=tx.init(jst.params))
    init = {k: np.asarray(v) for k, v in flatten_params(jst.params).items()}
    stats = {k: np.asarray(v) for k, v in flatten_params(jst.batch_stats).items()}
    jstep = jax.jit(jax_state.make_train_step(
        JaxRON(spec=JAX_TINY_SPEC), JaxTargetEncoder(JAX_TINY_SPEC.anchor_layout(), JAX_TINY_SPEC.img_shape, 0.5, 0.3),
        tx, JaxRonLossConfig()))
    ref = []
    for i in range(steps):
        jst, m = jstep(jst, batch, jax.random.PRNGKey(i))
        ref.append({k: float(v) for k, v in m.items()})

    model, _, _, state, step = overfit_check.build("cpu", seed=None, optimizer=optimizer)
    model.load_state_dict(from_jax_params(init, stats), strict=True)
    n = overfit_check.SPEC.anchor_layout().num_anchors
    tbatch = overfit_check.device_batch(overfit_check.overfit_data(), "cpu")
    state, got = overfit_check.train(step, state, tbatch, steps,
                                     draws=lambda i: loss_draws(jax.random.PRNGKey(i), (8, n)), log_every=0)
    assert state.step == int(jst.step) == steps
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.keys() == r.keys()
        for k in r:
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else METRIC_RTOL
            np.testing.assert_allclose(g[k], r[k], rtol=rtol, err_msg=f"step {i} {k}")
    assert got[-1]["counts/positives"] > 0 and got[-1]["loss/localization"] > 0
    got_p, ref_p = to_jax_params(model, model.named_parameters()), flatten_params(jst.params)
    if lr is not None:
        # tensors that start at 0 (biases, BN offsets) hold only the update, which the L2 check below bounds
        moving = [k for k in ref_p if np.abs(init[k]).max() > 0]
        assert_tree_close({k: got_p[k] for k in moving}, {k: ref_p[k] for k in moving}, "params")
    diff = sum(float(np.sum(((got_p[k] - np.asarray(ref_p[k])).astype(np.float64)) ** 2)) for k in ref_p)
    moved = sum(float(np.sum((np.asarray(ref_p[k], np.float64) - init[k]) ** 2)) for k in ref_p)
    assert moved > 0 and np.sqrt(diff / moved) <= UPDATE_TOL, np.sqrt(diff / moved)
    assert_tree_close(to_jax_params(model, model.named_buffers()), flatten_params(jst.batch_stats), "batch stats")


def test_cli_runs_end_to_end_on_the_cpu(capsys):
    rc = overfit_check.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "overfit mAP(voc07) = " in out and "per-class AP:" in out
    assert ("OVERFIT CHECK: PASS" in out) == (rc == 0) and ("OVERFIT CHECK: FAIL" in out) == (rc == 1)


def test_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        overfit_check.main([])


@pytest.mark.slow
def test_400_steps_from_jax_init_learn_as_jax_does(jax_tool_setup):
    from ron_tensorflow_tpu.inference import DetectionConfig as JaxDetectionConfig
    from ron_tensorflow_tpu.inference import Detector as JaxDetector
    from ron_tensorflow_tpu.ops.ap import StreamingTpFp as JaxStreamingTpFp
    from ron_tensorflow_tpu.ops.matching import match_all_classes as jax_match_all_classes

    jst, tx, batch = jax_tool_setup["state"], jax_tool_setup["tx"], jax_tool_setup["batch"]
    init = {k: np.asarray(v) for k, v in flatten_params(jst.params).items()}
    stats = {k: np.asarray(v) for k, v in flatten_params(jst.batch_stats).items()}
    jmodel = JaxRON(spec=JAX_TINY_SPEC)
    jstep = jax.jit(jax_state.make_train_step(
        jmodel, JaxTargetEncoder(JAX_TINY_SPEC.anchor_layout(), JAX_TINY_SPEC.img_shape, 0.5, 0.3), tx,
        JaxRonLossConfig()))
    for i in range(overfit_check.STEPS):
        jst, _ = jstep(jst, batch, jax.random.PRNGKey(i))
    # JAX's own evaluation of its weights (tools/overfit_check.py:88-113)
    scores, boxes = JaxDetector(jmodel, JAX_TINY_SPEC, JaxDetectionConfig(top_k=64, keep_top_k=16,
                                                                         select_threshold=0.1))(
        {"params": jst.params, "batch_stats": jst.batch_stats}, batch["image"])
    res = jax.vmap(lambda s, b, gl, gb: jax_match_all_classes(JAX_TINY_SPEC.num_classes, s, b, gl, gb,
                                                              jax.numpy.zeros_like(gl), 0.5))(
        scores, boxes, batch["gt_labels"], batch["gt_boxes"])
    acc = JaxStreamingTpFp(JAX_TINY_SPEC.num_classes)
    for img in range(8):
        for c in range(1, JAX_TINY_SPEC.num_classes):
            acc.add(c, np.asarray(res.n_gt[img, c - 1]), np.asarray(scores[img, c - 1]),
                    np.asarray(res.tp[img, c - 1]), np.asarray(res.fp[img, c - 1]))
    _, jax_aps = acc.mean_average_precision("voc07")
    jax_used = {c: v for c, v in jax_aps.items() if acc.n_gt[c] > 0}

    tbatch = overfit_check.device_batch(overfit_check.overfit_data(), "cpu")
    model, _, _, _, _ = overfit_check.build("cpu", seed=None)
    model.load_state_dict(from_jax_params({k: np.asarray(v) for k, v in flatten_params(jst.params).items()},
                                          {k: np.asarray(v) for k, v in flatten_params(jst.batch_stats).items()}),
                          strict=True)
    _, used = overfit_check.evaluate(model, tbatch, "cpu")
    assert used.keys() == jax_used.keys()
    np.testing.assert_allclose(list(used.values()), list(jax_used.values()), atol=1e-9)

    model, _, _, state, step = overfit_check.build("cpu", seed=None)
    model.load_state_dict(from_jax_params(init, stats), strict=True)
    n = overfit_check.SPEC.anchor_layout().num_anchors
    overfit_check.train(step, state, tbatch, overfit_check.STEPS,
                        draws=lambda i: loss_draws(jax.random.PRNGKey(i), (8, n)), log_every=0)
    _, used = overfit_check.evaluate(model, tbatch, "cpu")
    assert np.mean(list(used.values())) >= overfit_check.PASS_MAP, used
