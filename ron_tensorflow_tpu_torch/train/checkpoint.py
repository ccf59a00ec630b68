"""Checkpoints, auto-resume, warm start and checkpoint inspection.

Port of `ron_tensorflow_tpu/train/checkpoint.py`:

- `CheckpointManager`: train-state checkpoints with keep-N retention, in
  torch's own format (the reference's `tf.train.Saver(max_to_keep=5)`,
  ron_net.py:395-418). Each step is a directory `<step>/` holding
  `train_state.pt`: the whole `TrainState.state_dict()` (step, parameters,
  BatchNorm buffers, optimizer state, EMA) written with `torch.save`, to a
  temporary name first and then renamed, so that a reader never sees half a
  file. Saves are synchronous; `wait` has nothing to wait for.
  `restore_eval` reads parameters and BatchNorm buffers (or the EMA) only,
  whatever optimizer wrote the checkpoint.
- Warm start (ref: tf_utils.py:186-244): `warm_start_params` overlays
  source tensors onto a parameter tree, excluding scopes by prefix or
  regex, renaming scopes, tolerating missing tensors.
- Importers: `torch_vgg_to_flat` (torchvision and ssd.pytorch VGG-16
  state dicts), and in `tf_checkpoint.py` and `caffe_import.py` the TF
  slim and Caffe ones. Each gives flax-flat names ('backbone/conv1_1/conv/
  kernel') in flax layouts (HWIO kernels), as the JAX package's do, so that
  the two compare key by key; `weights.from_jax_params` carries them into
  the port's modules.
- `load_orbax_npz`: the JAX package's orbax checkpoints, after
  `tools/orbax_to_npz.py` has turned a model dir's step into one npz (the
  port does not read orbax's own format).
- `inspect_params`: the `inspect_checkpoint.py` listing
  (ref: inspect_checkpoint.py:32-131).

Parameter trees here are nested dicts of numpy arrays keyed as flax's are;
`flatten_params` joins their paths with '/' in sorted key order, as
`jax.tree_util` walks a dict.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

STATE_FILE = "train_state.pt"
ORBAX_CONVERTER = "tools/orbax_to_npz.py"


def flatten_params(params) -> Dict[str, object]:
    """{'a': {'b': x}} -> {'a/b': x}, keys in sorted order at each level."""
    flat = {}

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                flat[key] = v

    walk(params, "")
    return flat


def unflatten_params(flat: Dict[str, object]) -> Dict[str, object]:
    tree: Dict[str, object] = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


# --------------------------------------------------------------------------- #
# Train-state checkpoints
# --------------------------------------------------------------------------- #


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
        """Write `state` (a `TrainState`, or its `state_dict()`) as step
        `step`, then drop all but the newest `max_to_keep` steps."""
        step_dir = os.path.join(self._dir, str(int(step)))
        os.makedirs(step_dir, exist_ok=True)
        path = os.path.join(step_dir, STATE_FILE)
        torch.save(state if isinstance(state, dict) else state.state_dict(), path + ".tmp")
        os.replace(path + ".tmp", path)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)))

    def _load(self, step: Optional[int]) -> Tuple[Dict, int]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        path = os.path.join(self._dir, str(step), STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True), step

    def restore(self, state, step: Optional[int] = None):
        """Load step `step` (the latest by default) into `state` in place
        and return it."""
        saved, _ = self._load(step)
        state.load_state_dict(saved)
        return state

    def restore_eval(self, step: Optional[int] = None, use_ema: bool = False) -> Tuple[Dict, int]:
        """What inference needs, whatever optimizer trained the checkpoint
        (its state is not read): ({"params": ..., "batch_stats": ...}, step),
        CPU tensors under the port's names. With `use_ema`, the EMA takes
        the parameters' place where the checkpoint has one."""
        saved, step = self._load(step)
        params = saved["params"]
        if use_ema and saved.get("ema_params") is not None:
            params = saved["ema_params"]
        return {"params": dict(params), "batch_stats": dict(saved["batch_stats"])}, step

    def reload(self) -> None:
        """Every call lists the directory anew, so steps that another
        process writes are seen without this; kept for the JAX manager's
        surface (its orbax manager caches the step list)."""

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""


# --------------------------------------------------------------------------- #
# Warm start (fine-tune restore)
# --------------------------------------------------------------------------- #


def overlay_params(
    flat: Dict[str, object],
    restore_flat: Dict[str, np.ndarray],
    exclude_scopes: Sequence[str] = (),
    rename_map: Optional[Dict[str, str]] = None,
    ignore_missing: bool = True,
    verbose: bool = True,
) -> Tuple[Dict[str, object], List[str]]:
    """`warm_start_params` on a flat dict: (the overlaid dict, the keys
    restored from `restore_flat`)."""
    out = dict(flat)
    restored, missing = [], []
    for key, value in flat.items():
        if any(key.startswith(s) or re.search(s, key) for s in exclude_scopes):
            continue
        src_key = key
        if rename_map:
            for tgt_prefix, src_prefix in rename_map.items():
                if key.startswith(tgt_prefix):
                    src_key = src_prefix + key[len(tgt_prefix):]
                    break
        if src_key in restore_flat:
            src = np.asarray(restore_flat[src_key])
            if src.shape != value.shape:
                raise ValueError(f"shape mismatch for {key}: ckpt {src.shape} vs model {value.shape}")
            out[key] = src.astype(np.asarray(value).dtype)
            restored.append(key)
        else:
            missing.append(key)
    if missing and not ignore_missing:
        raise KeyError(f"missing tensors for: {missing[:10]}...")
    if verbose:
        print(f"[warm-start] restored {len(restored)} tensors, {len(missing)} left at init")
    return out, restored


def warm_start_params(
    params,
    restore_flat: Dict[str, np.ndarray],
    exclude_scopes: Sequence[str] = (),
    rename_map: Optional[Dict[str, str]] = None,
    ignore_missing: bool = True,
    verbose: bool = True,
):
    """Overlay restored tensors onto freshly-initialized params.

    Args:
      params: target parameter tree (values replaced where matched).
      restore_flat: flat {'a/b/kernel': array} source tensors.
      exclude_scopes: scopes NOT to restore, each matched as a path prefix
        or as a regex anywhere in the path (the reference excludes
        'reverse_module' when loading classification weights,
        ref: ron_net.py:139-141 + tf_utils.py:205-219).
      rename_map: {target_prefix: source_prefix} scope renames (the
        model_name -> 'vgg_16' trick, ref: tf_utils.py:221-229).
      ignore_missing: tolerate source tensors absent for a target
        (ref: tf_utils.py:231-240).
    Values are cast to the target's dtype; a shape mismatch raises.
    """
    out, _ = overlay_params(flatten_params(params), restore_flat, exclude_scopes, rename_map, ignore_missing,
                            verbose)
    return unflatten_params(out)


# PyTorch torchvision-style VGG16 conv layer indices (features.N) in order.
_TORCH_VGG16_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_OUR_VGG16_CONV_NAMES = (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
    "conv3_3", "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2",
    "conv5_3",
)


def torch_vgg_to_flat(
    state_dict: Dict[str, object],
    backbone_prefix: str = "backbone",
    bgr_to_rgb: bool = False,
) -> Dict[str, np.ndarray]:
    """Map a PyTorch VGG16(-reducedfc) state_dict to flax-flat names.

    Accepts torchvision ('features.N.weight') and ssd.pytorch
    ('vgg.N.weight', fc6/fc7 at indices 31/33) layouts. Conv weights
    transpose OIHW -> HWIO. With `bgr_to_rgb`, the first conv's input
    channels are reversed so a BGR-trained checkpoint consumes RGB input
    (the reference's caffe importer does the same flip,
    ref: nets/caffe_scope.py:33-39). `backbone_prefix=''` gives SSD's
    top-level names.
    """
    def to_np(v):
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    sd = {k: to_np(v) for k, v in state_dict.items()}
    prefix = "features." if any(k.startswith("features.") for k in sd) else "vgg."
    pfx = f"{backbone_prefix}/" if backbone_prefix else ""
    flat: Dict[str, np.ndarray] = {}

    def put_conv(our_name: str, w: np.ndarray, b: np.ndarray, flip_input=False):
        w = np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO
        if flip_input:
            w = w[:, :, ::-1, :]
        flat[f"{pfx}{our_name}/conv/kernel"] = w
        flat[f"{pfx}{our_name}/conv/bias"] = b

    for i, (idx, name) in enumerate(zip(_TORCH_VGG16_CONV_IDS, _OUR_VGG16_CONV_NAMES)):
        wk, bk = f"{prefix}{idx}.weight", f"{prefix}{idx}.bias"
        if wk not in sd:
            continue
        put_conv(name, sd[wk], sd[bk], flip_input=bgr_to_rgb and i == 0)

    # ssd.pytorch reduced fc6/fc7 live at vgg.31 / vgg.33
    for idx, name in ((31, "fc6"), (33, "fc7")):
        wk, bk = f"{prefix}{idx}.weight", f"{prefix}{idx}.bias"
        if wk in sd:
            put_conv(name, sd[wk], sd[bk])
    return flat


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def load_orbax_npz(path: str) -> Dict[str, object]:
    """The npz that `tools/orbax_to_npz.py` writes from a JAX model dir:
    {"params": flat, "batch_stats": flat, "ema_params": flat or None,
    "step": int}, flax-flat names in flax layouts."""
    if os.path.isdir(path):
        raise IsADirectoryError(
            f"{path} is a directory: the port does not read orbax checkpoints; convert the step with "
            f"`python {ORBAX_CONVERTER} MODEL_DIR OUT.npz` where JAX and orbax are installed, and pass the npz")
    out: Dict[str, object] = {"params": {}, "batch_stats": {}, "ema_params": None, "step": 0}
    with np.load(path, allow_pickle=False) as f:
        for key in f.files:
            if key == "step":
                out["step"] = int(f[key])
                continue
            part, _, name = key.partition("/")
            if part not in ("params", "batch_stats", "ema_params"):
                raise KeyError(f"{path}: unexpected entry {key!r}")
            if out[part] is None:
                out[part] = {}
            out[part][name] = f[key]
    return out


# --------------------------------------------------------------------------- #
# Inspection
# --------------------------------------------------------------------------- #


def inspect_params(params, pattern: Optional[str] = None) -> List[str]:
    """Human-readable tensor listing (name, shape, dtype, l2 norm) of a
    flax-named tree or flat dict: the `inspect_checkpoint.py` capability."""
    lines = []
    for key, leaf in sorted(flatten_params(params).items()):
        if pattern and not re.search(pattern, key):
            continue
        arr = np.asarray(leaf)
        lines.append(
            f"{key:70s} {str(arr.shape):20s} {str(arr.dtype):10s} "
            f"l2={float(np.sqrt((arr.astype(np.float64) ** 2).sum())):.4g}"
        )
    return lines
