"""Checkpointing without external deps: npz shards + JSON manifest.

Counterpart of ``repro.checkpoint.checkpoint``, in the same layout, so
that a directory written by one package reads in the other:

    <dir>/step_00000120/manifest.json     keys, shapes, dtypes, extra
    <dir>/step_00000120/shard_p0.npz      the arrays

Nested dicts and lists flatten to ``/``-joined keys (a list entry's key
is its index), dict keys in sorted order (the order ``jax.tree_util``
gives them); tensors are saved as numpy arrays.
One process writes, so there is one shard (a mesh run gathers its
blocks, and its rank 0 writes them).  Writes are atomic (tmp
dir + rename): a fault mid-write never corrupts the latest checkpoint, and
``latest_step`` skips incomplete directories.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.models.model import (_reference_layout, train_state_from_numpy,
                                      train_state_to_numpy)

__all__ = ["save_pytree", "restore_pytree", "latest_step",
           "save_train_state", "restore_train_state"]

_SEP = "/"


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix=()) -> dict:
    """``{"a": {"b": x}, "c": [y]}`` -> ``{"a/b": x, "c/0": y}``; ``None``
    leaves are empty."""
    if isinstance(tree, dict):
        items = sorted(tree.items(), key=lambda kv: str(kv[0]))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {_SEP.join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (str(k),)))
    return out


def _unflatten(template, data, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten(v, data, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, data, prefix + (str(i),))
                              for i, v in enumerate(template))
    return None if template is None else data[_SEP.join(prefix)]


def save_pytree(tree: dict, directory: str, step: int, *,
                extra: dict | None = None) -> str:
    """Write the nested dict ``tree`` (dicts and lists) as step ``step``
    of ``directory``; ``extra`` (JSON-serialisable) goes into the
    manifest."""
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
    the nested dict ``template`` (only its keys and list lengths matter).
    Returns ``(tree, manifest)`` with numpy leaves."""
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


def _rank0(comm) -> bool:
    names = comm.mesh.mesh_dim_names
    return comm.data_index(names) == 0


def save_train_state(state, directory: str, step: int, *, data_offset=0):
    """Write a ``train.TrainState`` in the reference's layout
    (``TrainState._asdict()``: ``params/...``, ``opt/m/...``,
    ``opt/v/...``, ``opt/step``, the layers grouped as the reference stacks
    them) with ``extra={"data_offset": ...}``, so the reference restores
    it.  numpy has no bfloat16 without ml_dtypes, so bf16 moments
    (``opt_dtype="bfloat16"``) are written as f32: exact, and cast back by
    ``restore_train_state``, but the reference then reads f32 leaves where
    its state holds bf16.  Cross-loading is held on f32 states.

    A sharded state (``models.placement.shard_train_state``, under the
    installed mesh) is gathered whole on every rank -- each must call
    this -- and rank 0 writes it, the same files as one process writes.
    Returns the step's directory."""
    from repro_torch.models import placement as PL
    from repro_torch.models import sharding as SH
    if PL.is_sharded(state.model):
        state = PL.gather_train_state(state)
        if not _rank0(SH.COMM):
            return os.path.join(directory, f"step_{step:08d}")
    return save_pytree(train_state_to_numpy(state), directory, step,
                       extra={"data_offset": int(data_offset)})


def restore_train_state(state_template, directory: str, step=None):
    """Restore step ``step`` (the latest by default) of a directory written
    by either package as a new ``train.TrainState`` with the template's
    config and device.  A sharded template restores the rank's blocks of
    the whole state (``sharding.local_block``): a run resumes on a mesh or
    on one card whatever wrote the files.  Returns ``(state,
    manifest)``."""
    from repro_torch.models import placement as PL
    model = state_template.model
    keys = _reference_layout(model, lambda n: 0)
    tree, manifest = restore_pytree(
        {"params": keys, "opt": {"m": keys, "v": keys, "step": 0}},
        directory, step)
    state = train_state_from_numpy(tree, model.cfg, model.device)
    if PL.is_sharded(model):
        state = PL.shard_train_state(state)
    return state, manifest
