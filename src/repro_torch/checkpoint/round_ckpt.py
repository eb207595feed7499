"""Round checkpoints of a boosted fit: ``GradientBoostedTrees.fit``
resumes from one bit for bit.

Counterpart of ``repro.checkpoint.round_ckpt``.  The boosting loop's only
state across rounds is (the trees so far, the additive raw scores, the
state of the fit's ``torch.Generator``), which stands where the
reference carries its PRNG key: the first r rounds of a fit are the
r-round fit, so restoring that triple and re-entering the loop at round r
grows the same remaining trees.  A checkpoint holds

  * every completed round's trees, stacked ``[T, max_nodes]`` per field,
  * the raw scores (``[M]``, or ``[C, M]`` for softmax), float32 (a host
    round trip is exact),
  * the generator state (``uint8``) under the key ``key``,
  * a config digest (``fit_digest``), checked on resume: resuming under
    another loss, config, seed, data or device would give an ensemble no
    uninterrupted fit gives, so it raises ``CheckpointMismatchError``.
    The port's digest hashes a framework tag with the device type, so a
    reference checkpoint (threefry key bits) is refused too; round
    checkpoints do not cross-load between the packages, tree checkpoints
    (``tree_ckpt``) do.

Every array's sha256 is kept in the manifest and checked on restore (npz
members are stored uncompressed, so a flipped byte would read back
silently); a truncated, flipped or unparseable checkpoint raises
``CheckpointCorruptError``.  Writes are atomic (``save_pytree``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import zipfile
import zlib
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (_to_numpy, latest_step,
                                               save_pytree)
from repro_torch.core.tree import TREE_FIELDS, Tree

__all__ = ["RoundState", "RoundCheckpoint", "RoundCheckpointer",
           "restore_round_state", "resolve_resume", "fit_digest",
           "CheckpointCorruptError", "CheckpointMismatchError"]

_FORMAT = 1


class CheckpointCorruptError(RuntimeError):
    """The checkpoint on disk is unreadable or fails its checksums."""


class CheckpointMismatchError(ValueError):
    """The checkpoint's config digest does not match the resuming fit."""


class RoundState(NamedTuple):
    """What ``fit`` hands its ``round_callback`` after each round:
    ``round`` counts completed rounds; ``raw`` is the live score tensor
    (on a mesh, the whole ``[M]`` / ``[C, M]`` gathered from the data
    shards), ``key`` the generator state.  ``primary`` is False on every
    rank of a mesh fit but global rank 0: a checkpoint is written once."""
    round: int
    trees: list
    raw: Any
    key: Any
    digest: str | None
    primary: bool = True


class RoundCheckpoint(NamedTuple):
    """A restored round checkpoint, accepted by ``fit(resume_from=...)``.
    ``digest=None`` skips the config check (an explicit escape hatch)."""
    round: int
    trees: list
    raw: np.ndarray
    key: np.ndarray
    digest: str | None


def _sha256(arr: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


class RoundCheckpointer:
    """``round_callback`` that saves the fit every ``every`` rounds;
    ``keep_last`` > 0 keeps only the newest ``keep_last`` steps.  On a mesh
    only the primary rank writes; every rank resumes from the directory."""

    def __init__(self, directory: str, *, every: int = 1,
                 keep_last: int = 0):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.directory = str(directory)
        self.every = every
        self.keep_last = keep_last

    def __call__(self, state: RoundState) -> None:
        if state.round % self.every or not state.primary:
            return
        stacked = {f: np.stack([_to_numpy(getattr(t, f))
                                for t in state.trees])
                   for f in TREE_FIELDS}
        payload = {"trees": stacked, "raw": _to_numpy(state.raw),
                   "key": _to_numpy(state.key)}
        checksums = {"trees/" + f: _sha256(v) for f, v in stacked.items()}
        checksums["raw"] = _sha256(payload["raw"])
        checksums["key"] = _sha256(payload["key"])
        save_pytree(payload, self.directory, state.round, extra={
            "format": _FORMAT,
            "round": state.round,
            "digest": state.digest,
            "n_nodes": [int(t.n_nodes) for t in state.trees],
            "checksums": checksums,
        })
        if self.keep_last:
            self._prune()

    def _prune(self) -> None:
        steps = sorted(
            int(fn.split("_")[1]) for fn in os.listdir(self.directory)
            if fn.startswith("step_") and not fn.endswith(".tmp"))
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)


def restore_round_state(directory: str,
                        step: int | None = None) -> RoundCheckpoint:
    """Load a round checkpoint (the latest step by default), checking every
    array against its sha256; trees come back as CPU tensors."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no round checkpoints in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest in {d}: {e}") from e
    extra = manifest.get("extra", {})
    if extra.get("format") != _FORMAT or "n_nodes" not in extra:
        raise CheckpointCorruptError(
            f"{d} is not a round checkpoint (format "
            f"{extra.get('format')!r}): wrong directory, or a manifest "
            "damaged at rest")
    data: dict[str, np.ndarray] = {}
    try:
        for fn in sorted(os.listdir(d)):
            if fn.startswith("shard_") and fn.endswith(".npz"):
                with np.load(os.path.join(d, fn)) as z:
                    data.update({k: z[k] for k in z.files})
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile, zlib.error) as e:
        raise CheckpointCorruptError(
            f"truncated or unreadable checkpoint shard in {d}: {e}") from e
    for key, want in extra.get("checksums", {}).items():
        if key not in data:
            raise CheckpointCorruptError(
                f"checkpoint {d} is missing array {key!r}")
        if _sha256(data[key]) != want:
            raise CheckpointCorruptError(
                f"checksum mismatch for {key!r} in {d}: the shard was "
                "corrupted at rest")
    n_nodes = extra["n_nodes"]
    try:
        trees = [Tree(n_nodes=int(n_nodes[i]),
                      **{f: torch.from_numpy(data["trees/" + f][i].copy())
                         for f in TREE_FIELDS})
                 for i in range(len(n_nodes))]
        raw, key = data["raw"], data["key"]
    except (KeyError, IndexError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {d} arrays do not match its manifest: {e}") from e
    return RoundCheckpoint(round=int(extra["round"]), trees=trees, raw=raw,
                           key=key, digest=extra.get("digest"))


def resolve_resume(spec, expect_digest: str | None) -> RoundCheckpoint:
    """``fit(resume_from=...)``: a directory is restored (latest step), a
    ``RoundCheckpoint`` passes through; the digest must match unless the
    checkpoint carries ``digest=None``."""
    ck = spec if isinstance(spec, RoundCheckpoint) else \
        restore_round_state(str(spec))
    if ck.digest is not None and expect_digest is not None \
            and ck.digest != expect_digest:
        raise CheckpointMismatchError(
            "resume_from checkpoint was written by a different fit "
            f"(digest {ck.digest[:12]}... vs this fit's "
            f"{expect_digest[:12]}...): framework, device, loss, config, "
            "GOSS, seed and data must all match for resume to be exact")
    return ck


def fit_digest(est, table, y, sample_weight=None, *, device, mesh=None,
               dist=None) -> str:
    """sha256 over everything the remaining rounds' bits depend on: the
    framework and device type (the generator's draws and the histogram
    arithmetic differ between CPU and CUDA, and between the packages), the
    loss and its parameters, the estimator's hyper-parameters, the full
    TreeConfig and GossConfig, the execution path (local, or the mesh's
    dims and sizes with the whole ``dist``, required with ``mesh``: the
    sharded draw and reduction order are part of the bits), the binned
    table, the labels and the sample weights."""
    h = hashlib.sha256()

    def put(tag: str, v) -> None:
        h.update(f"{tag}={v!r};".encode())

    def put_bytes(a: np.ndarray) -> None:
        h.update(np.ascontiguousarray(a).tobytes())

    put("framework", ("repro_torch", torch.device(device).type))
    lo = getattr(est, "_loss", None)
    if lo is None:
        lo = est._resolve_loss(y)
    put("loss", (lo.name, getattr(lo, "n_classes", None),
                 int(lo.link_id), bool(lo.constant_hessian)))
    put("n_trees", int(est.n_trees))
    put("lr", float(est.learning_rate))
    put("seed", int(est.seed))
    put("config", sorted(dataclasses.asdict(est.config).items()))
    put("goss", (None if est.goss is None
                 else sorted(dataclasses.asdict(est.goss).items())))
    if mesh is not None:
        put("path", ("mesh", tuple(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                     sorted(dataclasses.asdict(dist).items())))
    else:
        put("path", ("local",))
    bins = _to_numpy(table.bins)
    put("bins_meta", (bins.shape, str(bins.dtype)))
    put_bytes(bins)
    put_bytes(_to_numpy(table.n_num))
    put_bytes(_to_numpy(table.n_cat))
    y_arr = _to_numpy(y)
    put("y_meta", (y_arr.shape, str(y_arr.dtype)))
    put_bytes(y_arr)
    if sample_weight is not None:
        sw = _to_numpy(sample_weight).astype(np.float32)
        put("sw_meta", sw.shape)
        put_bytes(sw)
    else:
        put("sw_meta", None)
    return h.hexdigest()
