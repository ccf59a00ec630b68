"""The port's perf probes (`ron_tensorflow_tpu_torch/tools/perf_*.py`,
`leak_probe.py`) against the JAX probes of the same names (repo-root
`tools/`, read with `ast` or loaded by path; none of them is run, since
each builds RON-320 in JAX).

- Every probe runs end to end on the CPU at `RON_TINY_SPEC` shapes with one
  timed call and no warm-up, and returns its numbers under the JAX tool's
  row labels (the labels read from the JAX tool's source), each finite.
- `perf_block_times`: `conv_flops` and every case's FLOPs equal the JAX
  tool's own `conv_flops` and its per-case formulas (its source, run on
  stand-ins of its modules); the case names at 320 are the JAX tool's.
- `perf_remat12_bandwidth`: the traffic model (GB at bs 32) and the FLOPs
  equal the JAX tool's statements, run as written.
- `perf_post`: on seeded tiny `DetectorOutputs`, each stage's tensors equal
  the JAX tool's stage functions (decode, clip, gate and select within
  1e-6; the top-k, the gather and the NMS keep sets of JAX's vmapped
  `nms_sorted_fixpoint`). JAX's `lax.approx_max_k` off the TPU selects
  exactly (its aggregate step is an exact top-k), so the port's exact
  top-k is held to it value for value and index for index.
- `perf_train_experiments`: one f32 step of `remat`, `remat_dots` and
  `remat12` gives `base`'s loss, updated parameters and BatchNorm
  statistics within 1e-5; `bn_fast` in bf16: its loss within 2^-7
  relative (two bf16 roundings) of `base`'s, and its step bit-equal to
  `base` on the same model with every BatchNorm's own `fast_normalize` on
  (`RON(bn_fast_normalize=True)`'s switch). Its update is not held to
  base's: at batch 2 the tiny RON's block-6/7 BatchNorms normalize over 2
  to 8 values, where the bf16 scale/shift cancels, and the backbone's
  gradients change direction (a bound of 2^-4 of the update's norm, set
  before the run, read 0.24 against a norm of 0.18).
"""

import ast
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ron_tensorflow_tpu.models.testing import RON_TINY_SPEC as JAX_TINY_SPEC
from ron_tensorflow_tpu.ops import boxes as jax_boxes
from ron_tensorflow_tpu.ops import nms as jax_nms
from ron_tensorflow_tpu.ops.decode import decode_boxes as jax_decode_boxes

from ron_tensorflow_tpu_torch.inference.detector import DetectionConfig
from ron_tensorflow_tpu_torch.models import layers
from ron_tensorflow_tpu_torch.models.ron import DetectorOutputs
from ron_tensorflow_tpu_torch.models.spec import RON_TINY_SPEC
from ron_tensorflow_tpu_torch.tools import (
    leak_probe,
    perf_block_times,
    perf_breakdown,
    perf_common,
    perf_post,
    perf_remat12_bandwidth,
    perf_step_probe,
    perf_topk,
    perf_train_breakdown,
    perf_train_experiments,
)

REPO = Path(__file__).resolve().parent.parent
JAX_TOOLS = REPO / "tools"
TINY = ["--device", "cpu", "--model", "ron_tiny_vgg", "--iters", "1", "--warmup", "0"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_source(name: str) -> ast.Module:
    return ast.parse((JAX_TOOLS / f"{name}.py").read_text())


def jax_main(name: str) -> ast.FunctionDef:
    return next(n for n in jax_source(name).body if isinstance(n, ast.FunctionDef) and n.name == "main")


def load_jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", JAX_TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def strings(node) -> list:
    return [n.value for n in ast.walk(node) if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def numbers(tree) -> list:
    """Every number in a probe's returned dict, lists and dicts walked."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in numbers(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in numbers(v)]
    return [tree] if isinstance(tree, (int, float)) and not isinstance(tree, bool) else []


def all_finite(tree) -> bool:
    return all(math.isfinite(x) for x in numbers(tree))


# --------------------------------------------------------------------------- #
# The JAX tools' row labels


def jax_block_cases() -> list:
    """The JAX perf_block_times' case names, in order."""
    main = jax_main("perf_block_times")
    cases = next(n for n in ast.walk(main) if isinstance(n, ast.Assign)
                 and any(isinstance(t, ast.Name) and t.id == "cases" for t in n.targets))
    return [elt.elts[0].value for elt in cases.value.elts]


def jax_list(tool: str, var: str) -> list:
    """A list of strings assigned to `var` in the JAX tool's main."""
    main = jax_main(tool)
    node = next(n for n in ast.walk(main)
                if isinstance(n, ast.Assign) and any(isinstance(t, ast.Name) and t.id == var for t in n.targets))
    return strings(node.value)


def test_block_times_cases_are_the_jax_tools_at_320():
    assert [name for name, _, _ in perf_block_times.cases(320)] == jax_block_cases()


def test_breakdown_runs_end_to_end():
    rows = perf_breakdown.main(TINY + ["--batches", "1", "2"])
    assert list(rows) == [1, 2] and perf_breakdown.BATCHES == (1, 8, 32, 64)
    for r in rows.values():
        assert set(r) == {"fwd_ms", "post_ms", "full_ms", "img_s", "fwd_img_s"}
        assert all(v > 0 for v in r.values()) and all_finite(r)


def test_post_runs_end_to_end():
    rows = perf_post.main(TINY)
    jax_labels = [s.split(":")[0].strip() for s in strings(jax_main("perf_post")) if s.endswith(": ")]
    # the JAX tool's labels, but the top-k row's: the port's selection is exact
    assert jax_labels == ["scores+decode", "approx_top_k", "box gather", "fixpoint NMS", "full postproc"]
    assert list(rows) == ["scores+decode", "exact_top_k", "box gather", "fixpoint NMS", "full postproc"]
    assert all(v > 0 for v in rows.values()) and all_finite(rows)


def test_topk_runs_end_to_end():
    res = perf_topk.main(TINY + ["1"])
    e2e = next(n for n in ast.walk(jax_main("perf_topk")) if isinstance(n, ast.For) and isinstance(n.iter, ast.List))
    assert list(res["e2e"]) == [row.elts[0].value for row in e2e.iter.elts]
    assert list(res["standalone"]) == ["torch.topk"] + [f"chunked({nc})" for nc in (4, 8, 16, 32)]
    assert all(v > 0 for v in numbers(res)) and all_finite(res)


def test_block_times_runs_end_to_end():
    rows = perf_block_times.main(TINY + ["1"])
    assert list(rows) == [name for name, _, _ in perf_block_times.cases(64)]
    for r in rows.values():
        assert r["fwd_ms"] > 0 and r["fwdbwd_ms"] > 0 and r["flops"] > 0 and all_finite(r)


def test_remat12_runs_end_to_end():
    res = perf_remat12_bandwidth.main(TINY + ["1"])
    conditions = [s for s in strings(jax_main("perf_remat12_bandwidth")) if s.startswith("span ")]
    assert conditions == ["span fwd", "span fwd+bwd (saved acts)", "span fwd+bwd (remat)"]
    assert [k for k in res if k.startswith("span ")] == conditions
    assert all(v > 0 for v in numbers(res)) and all_finite(res)


def test_train_breakdown_runs_end_to_end():
    res = perf_train_breakdown.main(TINY + ["2"])
    for label in ("augment", "augment+encode", "fwd+loss", "grad (fwd+bwd)", "full train step"):
        assert any(s.strip().startswith(label) for s in strings(jax_main("perf_train_breakdown")))
        assert res[label] > 0
    assert res["img_s"] > 0 and all_finite(res)


def test_step_probe_runs_end_to_end():
    res = perf_step_probe.main(TINY + ["2"])
    assert list(perf_step_probe.NAMES) == jax_list("perf_step_probe", "names")
    assert [k for k in res if k != "img_s"] == list(perf_step_probe.NAMES)
    assert all(r["ms"] > 0 for k, r in res.items() if k != "img_s") and res["img_s"] > 0 and all_finite(res)


def test_train_experiments_runs_end_to_end():
    res = perf_train_experiments.main(TINY + ["2"])
    main = jax_main("perf_train_experiments")
    wanted = next(n for n in ast.walk(main) if isinstance(n, ast.BoolOp))  # sys.argv[2:] or [...]
    assert list(perf_train_experiments.VARIANTS) == strings(wanted)
    assert [k for k in res if k != "vs_base"] == list(perf_train_experiments.VARIANTS)
    assert all(r["ms"] > 0 and r["img_s"] > 0 for k, r in res.items() if k != "vs_base") and all_finite(res)
    assert not layers._BN_FAST_NORMALIZE


def test_train_experiments_raises_on_a_failing_variant():
    with pytest.raises(ValueError, match="unknown variant"):
        perf_train_experiments.main(TINY + ["2", "base", "xla_flags"])


def test_leak_probe_runs_end_to_end():
    res = leak_probe.main(["--device", "cpu", "0.5", "100"])
    assert [r["iter"] for r in res["rows"]] == [50, 100]
    assert res["base_rss_gb"] > 0 and all(r["ms_per_iter"] > 0 for r in res["rows"]) and all_finite(res)


def test_timeit_never_leaves_the_device_it_was_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        perf_common.timeit(lambda: None, iters=1, warmup=0, device="cuda")
    calls = []
    assert perf_common.timeit(lambda: calls.append(1), iters=3, warmup=2, device="cpu") >= 0 and len(calls) == 5


# --------------------------------------------------------------------------- #
# FLOPs and the traffic model against the JAX tools' formulas


def test_conv_flops_equal_the_jax_tools():
    jax_tool = load_jax_tool("perf_block_times")
    for args in [(320, 320, 3, 64), (40, 40, 1024, 210), (10, 10, 512, 1024, 1, 1), (7, 9, 5, 3, 3, 1)]:
        assert perf_block_times.conv_flops(*args) == jax_tool.conv_flops(*args)


def jax_case_flops(jax_tool, kind, convs, ishape, bs):
    """The JAX tool's per-case FLOP statements (from `flops = 0` to
    `flops *= bs`), run on stand-ins of its module classes."""
    main = jax_main("perf_block_times")
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For))
    body = loop.body
    start = next(i for i, s in enumerate(body) if isinstance(s, ast.Assign) and ast.unparse(s) == "flops = 0")
    end = next(i for i, s in enumerate(body) if isinstance(s, ast.AugAssign) and ast.unparse(s) == "flops *= bs")
    stubs = {k: type(k, (), {}) for k in ("Block", "ClsHead", "ObjectnessHead", "BoxHead")}
    mod = stubs[kind]()
    mod.convs = convs
    scope = {**stubs, "mod": mod, "ishape": ishape, "bs": bs, "conv_flops": jax_tool.conv_flops}
    exec(compile(ast.Module(body=body[start:end + 1], type_ignores=[]), "perf_block_times.py", "exec"), scope)
    return scope["flops"]


@pytest.mark.parametrize("side", [320, 64])
def test_case_flops_equal_the_jax_tools(side):
    jax_tool = load_jax_tool("perf_block_times")
    for name, ishape, mod in perf_block_times.cases(side):
        kind = type(mod).__name__
        convs = getattr(mod, "convs", None)
        assert perf_block_times.case_flops(mod, ishape, 32) == jax_case_flops(jax_tool, kind, convs, ishape, 32), name


def test_remat12_traffic_model_equals_the_jax_tools():
    """At bs 32 (the JAX tool's default): the JAX statements from the
    element counts to the FLOPs, run as written."""
    main = jax_main("perf_remat12_bandwidth")
    assigned = [ast.unparse(s.targets[0]) if isinstance(s, ast.Assign) else None for s in main.body]
    start, end = assigned.index("e_in"), assigned.index("flops_f")
    scope = {"bs": 32}
    exec(compile(ast.Module(body=main.body[start:end + 1], type_ignores=[]), "perf_remat12_bandwidth.py", "exec"),
         scope)
    gb = perf_remat12_bandwidth.traffic_gb(32)
    assert (gb["fwd"], gb["saved"], gb["remat"]) == (scope["gb_f"], scope["gb_g"], scope["gb_gr"])
    assert perf_remat12_bandwidth.span_flops(32) == scope["flops_f"]
    assert scope["gb_g"] > 0 and abs(gb["saved"] / gb["remat"] - scope["gb_g"] / scope["gb_gr"]) == 0


def test_no_tpu_peak_in_the_probes():
    for path in (REPO / "ron_tensorflow_tpu_torch" / "tools").glob("*.py"):
        text = path.read_text()
        assert "197" not in text and "819" not in text, path


# --------------------------------------------------------------------------- #
# perf_post's stages against the JAX tool's


def tiny_outputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    n = sum(h * w for h, w in RON_TINY_SPEC.feat_shapes) * 10
    logits = rng.normal(0.0, 3.0, (b, n, RON_TINY_SPEC.num_classes)).astype(np.float32)
    pred = np.exp(logits - logits.max(-1, keepdims=True))
    pred = (pred / pred.sum(-1, keepdims=True)).astype(np.float32)
    objness = rng.uniform(0.0, 0.1, (b, n)).astype(np.float32)
    locs = rng.normal(0.0, 0.7, (b, n, 4)).astype(np.float32)
    return pred, objness, locs


def test_post_stages_equal_the_jax_tools():
    cfg = DetectionConfig()
    pred, objness, locs = tiny_outputs()
    # the JAX tool's stages (tools/perf_post.py:54-78), on the CPU
    anchors = jnp.asarray(JAX_TINY_SPEC.anchor_layout().cyxhw)
    decoded = jax_boxes.clip_to_ref(jax_decode_boxes(jnp.asarray(locs), anchors, JAX_TINY_SPEC.prior_scaling))
    gate = jnp.asarray(objness) > cfg.objectness_threshold
    size_ok = jax_boxes.min_size_mask(decoded, cfg.min_size)
    scores = jnp.moveaxis(jnp.asarray(pred)[..., 1:], -1, -2)
    keep = (gate & size_ok)[:, None, :] & (scores > cfg.select_threshold)
    scores = jnp.where(keep, scores, 0.0)
    top_scores, top_idx = jax.lax.approx_max_k(scores, cfg.top_k)
    top_boxes = jnp.take_along_axis(decoded[:, None, :, :], top_idx[..., None], axis=2)
    f = lambda s, bx: jax_nms.nms_sorted_fixpoint(s, bx, cfg.nms_threshold, cfg.keep_top_k, cfg.nms_mode)  # noqa: E731
    nms_s, nms_b = jax.vmap(jax.vmap(f))(top_scores, top_boxes)

    out = DetectorOutputs(predictions=torch.from_numpy(pred), logits=None, objness_pred=torch.from_numpy(objness),
                          objness_logits=None, locations=torch.from_numpy(locs))
    port_anchors = torch.as_tensor(RON_TINY_SPEC.anchor_layout().cyxhw)
    p_scores, p_decoded = perf_post.stage_scores(out, port_anchors, RON_TINY_SPEC, cfg)
    np.testing.assert_allclose(p_decoded.numpy(), np.asarray(decoded), rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_scores.numpy(), np.asarray(scores), rtol=0, atol=1e-6)
    assert int((p_scores > 0).sum()) == int((scores > 0).sum()) > 0
    p_top_s, p_top_i = perf_post.stage_topk(p_scores, cfg)
    np.testing.assert_allclose(p_top_s.numpy(), np.asarray(top_scores), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(p_top_i.numpy(), np.asarray(top_idx))
    p_top_b = perf_post.stage_gather(p_decoded, p_top_i)
    np.testing.assert_allclose(p_top_b.numpy(), np.asarray(top_boxes), rtol=0, atol=1e-6)
    p_nms_s, p_nms_b = perf_post.stage_nms(p_top_s, p_top_b, cfg)
    # the keep sets: the same slots filled with the same candidates
    np.testing.assert_array_equal(p_nms_s.numpy() > 0, np.asarray(nms_s) > 0)
    assert 0 < int((p_nms_s > 0).sum()) < int((p_top_s > 0).sum())
    np.testing.assert_allclose(p_nms_s.numpy(), np.asarray(nms_s), rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_nms_b.numpy(), np.asarray(nms_b), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------- #
# perf_train_experiments' variants against base


def variant_step(parts, init, variant):
    step = perf_train_experiments.setup(parts, variant, init)
    layers.set_bn_fast_normalize(variant in perf_train_experiments.BN_FAST)
    try:
        metrics = perf_train_experiments.one_step(parts, step)
    finally:
        layers.set_bn_fast_normalize(False)
    return float(metrics["loss/total"]), {k: v.detach().clone() for k, v in parts.model.state_dict().items()}


def test_remat_variants_equal_base_in_f32():
    parts = perf_common.train_parts("cpu", "ron_tiny_vgg", bs=2, dtype=torch.float32)
    init = {k: v.detach().clone() for k, v in parts.model.state_dict().items()}
    base_loss, base = variant_step(parts, init, "base")
    assert not torch.equal(base["backbone.conv1_1.conv.weight"], init["backbone.conv1_1.conv.weight"])
    for variant in ("remat", "remat_dots", "remat12"):
        loss, after = variant_step(parts, init, variant)
        assert abs(loss - base_loss) <= 1e-5 * abs(base_loss), variant
        for k, v in base.items():
            torch.testing.assert_close(after[k], v, rtol=1e-5, atol=1e-5, msg=lambda m: f"{variant} {k}: {m}")


def test_bn_fast_against_base_in_bf16():
    parts = perf_common.train_parts("cpu", "ron_tiny_vgg", bs=2, dtype=torch.bfloat16)
    init = {k: v.detach().clone() for k, v in parts.model.state_dict().items()}
    base_loss, base = variant_step(parts, init, "base")
    loss, fast = variant_step(parts, init, "bn_fast")
    assert abs(loss - base_loss) <= 2.0 ** -7 * abs(base_loss)
    assert not layers._BN_FAST_NORMALIZE
    assert any(not torch.equal(fast[k], base[k]) for k in base)
    for m in parts.model.modules():
        if isinstance(m, layers.BatchNorm):
            m.fast_normalize = True
    switched_loss, switched = variant_step(parts, init, "base")
    assert switched_loss == loss
    for k, v in fast.items():
        assert torch.equal(switched[k], v), k
