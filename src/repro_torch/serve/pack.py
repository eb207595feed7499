"""Packed node-record byte model (part of ``repro.serve.pack``).

The serving layout of the reference packs each node into a narrow record:
``feat`` / ``tbin`` / ``loff`` (left-child offset) in the narrowest of
int8 / int16 / int32 that holds the field with its -1 sentinel, ``op``
always int8, plus a float32 leaf label.  This module keeps only the
functions that price those records from field ranges -- what the TOOT
sweep (``core.tuning``) uses to cost every design-space cell in serve
bytes.  The packer itself comes with the rest of serving.
"""
from __future__ import annotations

__all__ = ["walk_bytes_per_request", "predict_record_bytes",
           "FAT_STEP_BYTES", "LABEL_BYTES"]

# Per-(step, tree) bytes the float32 / int32 stacked walk
# (core.predict._walk) touches: leaf, left, count, feat, op, tbin -- six
# 4-byte fields; the label read (4 bytes per tree, once) is counted apart.
FAT_STEP_BYTES = 6 * 4
LABEL_BYTES = 4


def _field_width(max_value: int) -> int:
    """Bytes of the narrowest int8/int16/int32 holding [-1, max_value]."""
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
