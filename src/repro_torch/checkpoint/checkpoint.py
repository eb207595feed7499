"""Checkpointing without external deps: npz shards + JSON manifest.

Counterpart of ``repro.checkpoint.checkpoint``, in the same layout, so
that a directory written by one package reads in the other:

    <dir>/step_00000120/manifest.json     keys, shapes, dtypes, extra
    <dir>/step_00000120/shard_p0.npz      the arrays

Nested dicts flatten to ``/``-joined keys, dict keys in sorted order (the
order ``jax.tree_util`` gives them); tensors are saved as numpy arrays.
The port runs one process, so there is one shard.  Writes are atomic (tmp
dir + rename): a fault mid-write never corrupts the latest checkpoint, and
``latest_step`` skips incomplete directories.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

__all__ = ["save_pytree", "restore_pytree", "latest_step"]

_SEP = "/"


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix=()) -> dict:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}``; ``None`` leaves are empty."""
    out = {}
    for k in sorted(tree, key=str):
        v, path = tree[k], prefix + (str(k),)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        elif v is not None:
            out[_SEP.join(path)] = v
    return out


def _unflatten(template, data, prefix=()) -> dict:
    out = {}
    for k, v in template.items():
        path = prefix + (str(k),)
        if isinstance(v, dict):
            out[k] = _unflatten(v, data, path)
        else:
            out[k] = None if v is None else data[_SEP.join(path)]
    return out


def save_pytree(tree: dict, directory: str, step: int, *,
                extra: dict | None = None) -> str:
    """Write the nested dict ``tree`` as step ``step`` of ``directory``;
    ``extra`` (JSON-serialisable) goes into the manifest."""
    arrays = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shard_p0.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                 for k, v in arrays.items()},
        "n_processes": 1,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore_pytree(template: dict, directory: str, step: int | None = None):
    """Restore step ``step`` (the latest by default) into the structure of
    the nested dict ``template`` (only its keys matter).  Returns
    ``(tree, manifest)`` with numpy leaves."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = {}
    for fn in os.listdir(d):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(d, fn)) as z:
                data.update({k: z[k] for k in z.files})
    return _unflatten(template, data), manifest


def latest_step(directory: str) -> int | None:
    """The newest complete step of ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for fn in os.listdir(directory):
        if fn.startswith("step_") and not fn.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, fn, "manifest.json")):
            steps.append(int(fn.split("_")[1]))
    return max(steps) if steps else None
