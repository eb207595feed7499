"""The work a tree job needs, counted from its inputs' shapes and its trees'
own node counts, and the H100's peaks to hold it against.

The counts are of what the algorithm needs, whatever implements it, so a
later change that fuses or drops a kernel cannot change them; each byte is
counted once, so no share of a roofline can pass 100 %.

* Histogram: every row the level scatters reads its K bin codes and its
  statistics once, and every cell of the level's histogram is written
  once.  With sibling subtraction the root scatters every row and a level
  below scatters only the smaller child of each sibling pair (the other
  child is the parent's histogram less this one).
* Selection: each level's histogram block is read once.
* Router: each row at a node that splits reads its split feature's bin.
* TOOT: each validation row's path tables (label and count along the
  path) are written once.
* Boosting rounds add, per row of the whole table: the gradient pass (read
  score and label, write g and h), the GOSS pass (read the leverage and a
  uniform), and the score update (one bin per level of the walk, read and
  write the score).

Operations are float32 adds and multiplies: one add per statistic per
feature of a scattered row (and one multiply per statistic for a row
weight), about ten per candidate split scored.
"""
from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "FP32_OPS_PER_S", "roofline_s", "tree_work",
           "boost_round_extra"]

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_CANDIDATE = 10


def roofline_s(nbytes: float, nops: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S)


def tree_work(tree: dict, rows_per_node, *, n_features: int, n_bins: int,
              channels: int, weighted: bool) -> dict:
    """Counted bytes and operations of one level-wise build with sibling
    subtraction.  ``tree`` holds numpy fields (``depth``, ``left``,
    ``right``, ``leaf``) of its nodes; ``rows_per_node`` the rows that
    reached each node."""
    depth = np.asarray(tree["depth"])
    left = np.asarray(tree["left"])
    right = np.asarray(tree["right"])
    inner = ~np.asarray(tree["leaf"]) & (left >= 0)
    rows = np.asarray(rows_per_node, np.int64)
    row_bytes = 4 * n_features + 4 * channels + (4 if weighted else 0)
    cell_bytes = 4 * n_features * n_bins * channels
    scattered = int(rows[0])
    pairs = inner.nonzero()[0]
    scattered += int(np.minimum(rows[left[pairs]], rows[right[pairs]]).sum())
    n_nodes = len(depth)
    hist_bytes = scattered * row_bytes + n_nodes * cell_bytes
    hist_ops = scattered * n_features * channels * (2 if weighted else 1)
    select_bytes = n_nodes * cell_bytes
    select_ops = n_nodes * 3 * n_features * n_bins * OPS_PER_CANDIDATE
    route_bytes = 4 * int(rows[inner].sum())
    return dict(hist_bytes=hist_bytes, hist_ops=hist_ops,
                select_bytes=select_bytes, select_ops=select_ops,
                route_bytes=route_bytes, rows_scattered=scattered)


def boost_round_extra(m: int, max_depth: int) -> int:
    """Bytes of a boosting round's passes over the whole table."""
    return m * (16 + 8 + 4 * max_depth + 8)
