"""Packed node tables: the serving-side int8/int16 tree layout (counterpart
of ``repro.serve.pack``).

The training-side node table (``core.predict.WALK_FIELDS``) is eight
f32/i32 arrays -- 32 bytes per node -- because the builder and the
runtime-tuning walk need scores, counts, depths and both child pointers.
Serving needs none of that: the serve walk runs with no depth limit and
``min_samples_split = 0``, so per step it only reads *which feature to
test, how to test it, and where the left child lives*:

    field   meaning                              width
    -----   -----------------------------------  ---------------------
    feat    split feature id, -1 for leaves      int8 if K - 1 <= 127,
                                                 else int16 (int32 for
                                                 pathological K)
    op      predicate op {LE, GT, EQ}, -1 leaf   int8 (always fits)
    tbin    threshold / category bin             int8 if max bin <= 127,
                                                 else int16
    loff    left-child offset ``left - node``,   int8 / int16 / int32 by
            -1 for leaves                        the same overflow rule
    label   leaf value (f32, bit-preserved)      float32

``right`` needs no storage: the level-synchronous builder allocates
children in sibling pairs, so ``right == left + 1`` always (checked at
pack time).  ``leaf`` needs none either: a leaf is exactly ``loff < 0``.

``PackedForest`` is host-side numpy, as in the reference: the packer does
not depend on the device, and a reference ``PackedForest`` carries across
field by field.  The registry (``serve.registry``) moves the tables to the
device.  ``unpack`` is the lossless inverse (the parity oracle).  The byte
model below (``predict_record_bytes``, ``walk_bytes_per_request``) is what
the TOOT sweep (``core.tuning``) prices serve bytes with.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PackedForest", "pack_trees", "pack_stacked", "unpack",
           "walk_bytes_per_request", "predict_record_bytes",
           "FAT_STEP_BYTES", "LABEL_BYTES"]

# Per-(step, tree) bytes the float32 / int32 stacked walk
# (core.predict._walk) touches: leaf, left, count, feat, op, tbin -- six
# 4-byte fields; the label read (4 bytes per tree, once) is counted apart.
FAT_STEP_BYTES = 6 * 4
LABEL_BYTES = 4


def _narrowest(a: np.ndarray) -> np.ndarray:
    """Smallest of int8/int16/int32 that holds every value of ``a``."""
    for dt in (np.int8, np.int16, np.int32):
        info = np.iinfo(dt)
        if a.min() >= info.min and a.max() <= info.max:
            return a.astype(dt)
    raise OverflowError("node field exceeds int32")  # pragma: no cover


@dataclasses.dataclass(frozen=True)
class PackedForest:
    """One ensemble's packed node tables, host-side ([T, N] numpy arrays).

    ``feat``/``op``/``tbin``/``loff`` are the narrow structural record
    (dtypes chosen by ``pack_stacked``'s overflow rule); ``label`` is the
    bit-preserved f32 leaf value.  ``n_num`` is the [K] feature mask the
    predicate evaluation needs, ``meta`` the serving scalars exported by
    ``GradientBoostedTrees.export_stacked`` (learning_rate, base, link_id,
    num_steps, loss)."""
    feat: np.ndarray     # [T, N] int8/int16/int32, -1 = leaf
    op: np.ndarray       # [T, N] int8, -1 = leaf
    tbin: np.ndarray     # [T, N] int8/int16/int32
    loff: np.ndarray     # [T, N] left - node, -1 = leaf
    label: np.ndarray    # [T, N] float32 (lossless)
    n_num: np.ndarray    # [K] int32
    meta: dict

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.feat.shape[1]

    @property
    def record_bytes(self) -> int:
        """Structural bytes one walk step reads per (tree, node)."""
        return (self.feat.dtype.itemsize + self.op.dtype.itemsize
                + self.tbin.dtype.itemsize + self.loff.dtype.itemsize)


def pack_stacked(tables: dict, n_num, meta: dict,
                 n_valid: int | None = None) -> PackedForest:
    """Pack stacked [T, N] WALK_FIELDS node tables (numpy) into the narrow
    layout.

    Checks the two structural invariants the layout relies on --
    ``right == left + 1`` on every split node (sibling-pair allocation)
    and ``leaf => left == -1`` -- and chooses each field's width by the
    int8 -> int16 -> int32 overflow rule.  ``n_valid`` (the max node count
    over the stacked trees) trims the node axis to the slots a walk can
    reach."""
    if n_valid is not None:
        n_valid = max(1, int(n_valid))
        tables = {f: np.asarray(a)[:, :n_valid] for f, a in tables.items()}
    feat = np.asarray(tables["feat"], dtype=np.int64)
    op = np.asarray(tables["op"], dtype=np.int64)
    tbin = np.asarray(tables["tbin"], dtype=np.int64)
    left = np.asarray(tables["left"], dtype=np.int64)
    right = np.asarray(tables["right"], dtype=np.int64)
    label = np.asarray(tables["label"], dtype=np.float32)
    split = left >= 0
    if not np.array_equal(right[split], left[split] + 1):
        raise ValueError("packed layout requires right == left + 1 on "
                         "every split node (sibling-pair allocation)")
    if np.any(np.asarray(tables["leaf"])[split]):
        raise ValueError("packed layout requires leaf => left == -1")
    node = np.arange(left.shape[1], dtype=np.int64)[None, :]
    loff = np.where(split, left - node, -1)
    return PackedForest(
        feat=_narrowest(feat), op=op.astype(np.int8),
        tbin=_narrowest(tbin), loff=_narrowest(loff), label=label,
        n_num=np.asarray(n_num, dtype=np.int32), meta=dict(meta))


def pack_trees(ensemble) -> PackedForest:
    """Pack a fitted ``GradientBoostedTrees`` via its ``export_stacked``:
    the node axis is trimmed to the largest built tree (``Tree.n_nodes``)
    on the device, then each table crosses to the host once."""
    tables, n_num, meta = ensemble.export_stacked()
    n_valid = max(1, max(t.n_nodes for t in ensemble.trees))
    tables = {f: v[:, :n_valid].cpu().numpy() for f, v in tables.items()}
    return pack_stacked(tables, n_num, meta)


def unpack(packed: PackedForest) -> dict:
    """Lossless inverse of ``pack_stacked`` (the parity oracle):
    ``feat``, ``op``, ``tbin``, ``left``, ``right``, ``leaf`` (= ``loff <
    0``) and ``label`` as [T, N] numpy arrays at the training-side dtypes.
    The dropped fields (count/score/depth/parent) are not representable;
    serving never reads them."""
    loff = packed.loff.astype(np.int64)
    node = np.arange(packed.max_nodes, dtype=np.int64)[None, :]
    split = loff >= 0
    left = np.where(split, node + loff, -1)
    return dict(
        feat=packed.feat.astype(np.int32), op=packed.op.astype(np.int32),
        tbin=packed.tbin.astype(np.int32),
        left=left.astype(np.int32),
        right=np.where(split, left + 1, -1).astype(np.int32),
        leaf=~split, label=packed.label.astype(np.float32))


def _field_width(max_value: int) -> int:
    """Bytes of the narrowest int8/int16/int32 holding [-1, max_value]:
    the closed form of ``_narrowest``'s rule for the node fields."""
    if max_value <= 127:
        return 1
    if max_value <= 32767:
        return 2
    return 4


def predict_record_bytes(n_feat: int, n_bins: int, max_loff: int) -> int:
    """Packed record width from field ranges, without packing: feat needs
    ``n_feat - 1``, tbin ``n_bins - 1``, loff its largest left-child
    offset; op is always int8."""
    return (_field_width(n_feat - 1) + 1 + _field_width(n_bins - 1)
            + _field_width(max_loff))


def walk_bytes_per_request(n_trees, num_steps, record_bytes):
    """Node-table bytes one request row reads: one record per walk step
    per tree, plus one final label read per tree.  A function of shapes
    only; broadcasts over numpy arrays."""
    return num_steps * n_trees * record_bytes + n_trees * LABEL_BYTES
