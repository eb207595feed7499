"""The work one round of multiclass softmax boosting needs, counted from
its inputs' shapes and its class-trees' own nodes and rows (the softmax
twin of ``work.py``, whose peaks and roofline it shares).

A round grows its C class-trees in depth lockstep, and each level of the
round is one class-stacked histogram launch: the C lanes' rows over the
one shared table of bin codes.  Each byte is counted once:

* Histogram, per level: the bin codes (4 B a feature) of every row that
  some lane scatters there, read once for the launch however many lanes
  scatter it; each lane's scattered rows' 3 moment channels and weight
  (16 B); each lane's level nodes' ``[K, B, 3]`` cells, written once.
  With sibling subtraction every lane scatters every row at the root and
  below it the rows of the smaller child of each sibling pair (fewer rows,
  the left child on a tie), as the build does.
* Selection: each lane's level histogram read once.
* Router: each row at a node that splits reads its split feature's bin.
* The round's passes over ``[C, M]``: the gradient pass (each row's label
  once, 8 B; a class-row reads its score and writes g, h and the target,
  16 B) and the score update (a class-row reads one bin a level of the
  walk and reads and writes its score).

Operations are ``work.py``'s: one add and one multiply (the weight) a
statistic a feature of a scattered lane row, and ``OPS_PER_CANDIDATE`` a
candidate split scored.

A level's chunks count as one launch: at the cell's widths (at most 32
nodes a level against 2,122 slots a chunk) each level is one chunk.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.tree import predicate
from portbench.work import tree_work

__all__ = ["round_rows", "round_work", "round_extra_bytes"]

MOMENTS = 3


def _small_children(tree: dict, rows) -> np.ndarray:
    """Whether each node is the child its pair scatters: the one with
    fewer rows, the left one on a tie (the root counts as scattered)."""
    left = np.asarray(tree["left"])
    right = np.asarray(tree["right"])
    inner = ~np.asarray(tree["leaf"]) & (left >= 0)
    small = np.zeros(len(left), bool)
    small[0] = True
    lo, hi = left[inner], right[inner]
    left_small = rows[lo] <= rows[hi]
    small[lo[left_small]] = True
    small[hi[~left_small]] = True
    return small


def round_rows(trees, bins, n_num, max_depth: int):
    """``(rows_per_node, union)`` of one round's class-trees (numpy
    fields, as ``reference.tree.judge`` reads them) on the rows ``bins``:
    the rows that reach each node of each tree, and for each level the
    rows that at least one lane scatters there."""
    dev = bins.device
    m = bins.shape[0]
    n_num = n_num.to(dev).long()
    ts = [{k: torch.as_tensor(np.asarray(v), device=dev) for k, v in t.items()}
          for t in trees]
    nodes = [torch.zeros(m, dtype=torch.long, device=dev) for _ in trees]
    rows = [np.zeros(len(t["depth"]), np.int64) for t in trees]
    for r in rows:
        r[0] = m
    union = [m]
    for _ in range(1, max_depth):
        moved = []
        for t, node in zip(ts, nodes):
            inner = ~t["leaf"][node] & (t["left"][node] >= 0)
            f = t["feat"][node].clamp(min=0).long()
            xb = bins.gather(1, f[:, None])[:, 0].long()
            go = predicate(xb, n_num[f], t["op"][node].long(),
                           t["tbin"][node].long())
            child = torch.where(go, t["left"][node], t["right"][node]).long()
            node.copy_(torch.where(inner, child, node))
            moved.append(inner)
        if not any(bool(x.any()) for x in moved):
            break
        scattered = torch.zeros(m, dtype=torch.bool, device=dev)
        for t, r, node, mv in zip(trees, rows, nodes, moved):
            r += torch.bincount(node[mv], minlength=len(r)).cpu().numpy()
            small = torch.as_tensor(_small_children(t, r), device=dev)
            scattered |= mv & small[node]
        union.append(int(scattered.sum()))
    return rows, union


def round_work(trees, rows_per_node, union, *, n_features: int,
               n_bins: int) -> dict:
    """Counted bytes and operations of one round's histogram, selection
    and routing, from its class-trees (numpy fields), the rows at each of
    their nodes and the rows scattered at each level (``round_rows``):
    ``work.tree_work`` of each lane, with the bin codes read once a
    launch."""
    out: dict = {}
    for tree, rows in zip(trees, rows_per_node):
        w = tree_work(tree, rows, n_features=n_features, n_bins=n_bins,
                      channels=MOMENTS, weighted=True)
        for k, v in w.items():
            out[k] = out.get(k, 0) + v
    n_nodes = sum(len(t["depth"]) for t in trees)
    out["launch_rows"] = int(sum(union))
    out["hist_bytes"] = (4 * n_features * out["launch_rows"]
                         + 4 * (MOMENTS + 1) * out["rows_scattered"]
                         + n_nodes * 4 * n_features * n_bins * MOMENTS)
    return out


def round_extra_bytes(m: int, n_classes: int, max_depth: int) -> int:
    """Bytes of a round's passes over the ``[C, M]`` scores."""
    return m * (8 + n_classes * (16 + 4 * max_depth + 8))
