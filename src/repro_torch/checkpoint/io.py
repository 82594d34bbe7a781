"""Checkpoints: a tree -> <directory>/step_XXXXXXXX/{manifest.json,
arrays.npz}.

Counterpart of `repro/checkpoint/io.py`, on the same layout, so a
checkpoint written by either package loads in the other:

  - `save_checkpoint` / `load_checkpoint`: template-shaped trees (an
    `AFTOState`, a parameter tree); the caller supplies the structure on
    load.  Leaf i is stored as `leaf_i`, numbered in the reference's
    flatten order (`utils.tree.tree_flatten`: dict keys sorted, state
    dataclasses by field), so one file means the same to both packages.
    A bf16 leaf is stored as f32 (exact) and restored to the template's
    dtype.
  - `save_array_dict` / `load_array_dict`: self-describing flat
    name -> array dicts, whose manifest carries a crc32 of the npz
    payload; a truncated or corrupt checkpoint raises `CheckpointError`
    instead of loading garbage.

Writes are atomic (a temporary directory inside `directory`, then
`os.replace`) and keep the newest `keep` steps.  The directory is made
before the temporary one, so the temporary directory always lies beside
its target, even on the first save into a new directory.
"""
from __future__ import annotations

import io as _io
import json
import os
import shutil
import tempfile
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten, tree_unflatten


class CheckpointError(RuntimeError):
    """A checkpoint is missing, truncated, fails its checksum or does not
    fit the template."""


def _storable(x):
    """(numpy array npz can hold, dtype name): tensors leave the device;
    a dtype numpy lacks (bf16, float8) is stored as f32, which holds it
    exactly."""
    if torch.is_tensor(x):
        x = x.detach()
        name = str(x.dtype).replace("torch.", "")
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            return x.float().cpu().numpy(), name
        return x.cpu().numpy(), name
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _write_step(directory: str, step: int, arrays: Dict[str, np.ndarray],
                manifest_of, keep: int) -> str:
    """Write arrays.npz and the manifest `manifest_of(npz_bytes)` into
    <directory>/step_<step> atomically, then keep the newest `keep`."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".ckpt_tmp_")
    try:
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **arrays)
        with open(npz_path, "rb") as f:
            manifest = manifest_of(f.read())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for old in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, old), ignore_errors=True)
    return final


def save_checkpoint(directory: str, tree: Any, step: int,
                    keep: int = 3) -> str:
    """Write <directory>/step_<step>/{manifest.json, arrays.npz}."""
    leaves, tdef = tree_flatten(tree)
    stored = [_storable(x) for x in leaves]
    manifest = {
        "step": int(step),
        "treedef": str(tdef),
        "n_leaves": len(leaves),
        "dtypes": [d for _, d in stored],
        "shapes": [list(a.shape) for a, _ in stored],
    }
    return _write_step(directory, step,
                       {f"leaf_{i}": a for i, (a, _) in enumerate(stored)},
                       lambda _payload: manifest, keep)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    return steps[-1] if steps else None


def _step_path(directory: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise CheckpointError(f"no checkpoints in {directory!r}")
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.isdir(path):
        raise CheckpointError(f"no checkpoint of step {step} in "
                              f"{directory!r}")
    return path


def _read_manifest(path: str) -> dict:
    man_path = os.path.join(path, "manifest.json")
    try:
        with open(man_path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(
            f"unreadable manifest at {man_path}: {e}") from e


def load_checkpoint(directory: str, template: Any,
                    step: Optional[int] = None) -> Any:
    """The checkpoint of `step` (the latest if None) in `template`'s
    structure, every leaf in its template leaf's dtype and, for a
    tensor, on its device.  Raises `CheckpointError` when the step is
    missing or the leaves do not fit the template."""
    path = _step_path(directory, step)
    if _read_manifest(path).get("format") == "array_dict":
        raise CheckpointError(f"{path} is an array-dict checkpoint; use "
                              "load_array_dict")
    leaves, tdef = tree_flatten(template)
    try:
        npz = np.load(os.path.join(path, "arrays.npz"), allow_pickle=False)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"unreadable array payload in {path}: {e}") \
            from e
    with npz:
        if len(npz.files) != len(leaves):
            raise CheckpointError(
                f"{path} holds {len(npz.files)} leaves, the template "
                f"{len(leaves)}")
        restored = []
        for i, tpl in enumerate(leaves):
            arr = npz[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(np.shape(tpl)):
                raise CheckpointError(
                    f"leaf {i}: checkpoint shape {arr.shape} != template "
                    f"{tuple(np.shape(tpl))}")
            if torch.is_tensor(tpl):
                restored.append(torch.from_numpy(np.array(arr)).to(
                    device=tpl.device, dtype=tpl.dtype))
            else:
                restored.append(np.asarray(arr, dtype=np.asarray(tpl).dtype))
    return tree_unflatten(tdef, restored)


# ---------------------------------------------------------------------------
# self-describing array-dict checkpoints
# ---------------------------------------------------------------------------

def save_array_dict(directory: str, arrays: Dict[str, Any], step: int,
                    keep: int = 3) -> str:
    """Write a flat name -> array dict (tensors or arrays) as
    <directory>/step_<step>/{manifest.json, arrays.npz}, atomically, with
    retention and a crc32 of the npz payload in the manifest.  The names
    travel with the data: no template is needed to load."""
    stored = {k: _storable(v)[0] for k, v in arrays.items()}
    return _write_step(
        directory, step, stored,
        lambda payload: {"step": int(step), "format": "array_dict",
                         "keys": sorted(arrays),
                         "crc32": zlib.crc32(payload)}, keep)


def load_array_dict(directory: str,
                    step: Optional[int] = None) -> Dict[str, np.ndarray]:
    """An array-dict checkpoint (the latest step if None) as numpy.

    Raises `CheckpointError`, never garbage, when the checkpoint is
    missing, the manifest is unreadable or of the template format, the
    payload fails its crc32, or the stored keys differ from the
    manifest's."""
    path = _step_path(directory, step)
    manifest = _read_manifest(path)
    if manifest.get("format") != "array_dict":
        raise CheckpointError(
            f"{path} is not an array-dict checkpoint "
            f"(format={manifest.get('format')!r}); use load_checkpoint")
    npz_path = os.path.join(path, "arrays.npz")
    try:
        with open(npz_path, "rb") as f:
            payload = f.read()
    except OSError as e:
        raise CheckpointError(
            f"missing array payload at {npz_path}: {e}") from e
    crc = zlib.crc32(payload)
    if crc != int(manifest.get("crc32", -1)):
        raise CheckpointError(
            f"checksum mismatch for {npz_path}: stored "
            f"{manifest.get('crc32')}, computed {crc}; the checkpoint is "
            "corrupt or truncated")
    try:
        with np.load(_io.BytesIO(payload), allow_pickle=False) as npz:
            out = {k: npz[k] for k in npz.files}
    except Exception as e:
        raise CheckpointError(
            f"undecodable array payload at {npz_path}: {e}") from e
    if sorted(out) != list(manifest.get("keys", [])):
        raise CheckpointError(
            f"key set mismatch in {path}: the manifest lists "
            f"{len(manifest.get('keys', []))} keys, the payload has "
            f"{len(out)}")
    return out
