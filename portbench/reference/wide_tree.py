"""Plain reference judge of a wide class tree, a level at a time in blocks
of nodes (PyTorch, float64, no kernels).

``judge`` gives what ``tree.judge`` gives for a class tree (at ``tol`` 0,
as the fit-and-tune cells judge), with the arithmetic imported from it:
the rows that reach each node routed with the paper's Table 3
predicates, each node's count and label, the best split score over every
candidate, the chosen split's gap below it and the stopping rules.
``tree.judge`` builds a whole level's ``[W, K, B, C]`` histogram and its
candidate scores at once, which at the thousands of nodes a level of a
fully grown tree on a large table does not fit a card; here a level is
worked through in blocks of nodes, each block's histogram built from its
own rows, so that one block's histogram and the arrays
``candidate_scores`` makes of it stay under ``budget_bytes``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.tree import (NEG, TREE_KEYS, Rules, _node_stats,
                                      candidate_scores, level_hist, predicate)

__all__ = ["judge", "block_nodes", "BUDGET_BYTES", "COPIES"]

BUDGET_BYTES = 8 << 30
# float64 arrays of one node's histogram size that ``candidate_scores``
# holds at once, at most (the three families' sides, their logs and
# products), with the histogram itself
COPIES = 32


def block_nodes(n_features: int, n_bins: int, channels: int,
                budget_bytes: int = BUDGET_BYTES) -> int:
    """Nodes a block may hold so that its float64 histogram and the
    arrays scored from it stay under ``budget_bytes``."""
    per_node = COPIES * n_features * n_bins * channels * 8
    return max(1, budget_bytes // per_node)


def _block(bins, stats, n_num, n_cat, n_bins, rules, t, ids_d, node_of_row,
           d, n):
    """Judge the nodes ``ids_d`` of level ``d`` and route their rows one
    level down.  Returns ``(rows, node_bad, rule_bad, gain_gap,
    any_inner)``."""
    dev = bins.device
    f64 = torch.float64
    w = ids_d.numel()
    slot_of = torch.full((n,), -1, dtype=torch.long, device=dev)
    slot_of[ids_d] = torch.arange(w, device=dev)
    slot = slot_of[node_of_row]
    rows = torch.bincount(slot[slot >= 0], minlength=w)
    hist = level_hist(bins, stats, slot, w, n_bins, f64)
    cnt, lab, pure = _node_stats(hist[:, 0].sum(1), rules)
    leaf = t["leaf"][ids_d] | (t["left"][ids_d] < 0)
    node_bad = int(((cnt != t["count"][ids_d].to(f64))
                    | (lab != t["label"][ids_d].to(f64))).sum())
    score, size_p, size_n = candidate_scores(hist, n_num, n_cat, rules)
    del hist
    best, arg = score.reshape(w, -1).max(1)
    child_min = torch.minimum(
        size_p.reshape(w, -1).gather(1, arg[:, None]),
        size_n.reshape(w, -1).gather(1, arg[:, None]))[:, 0]
    del size_p, size_n
    light = (child_min <= rules.min_child_weight if rules.min_child_weight
             else torch.zeros_like(pure))
    must_split = (~pure & (best > NEG) & (cnt >= rules.min_samples_split)
                  & (d < rules.max_depth) & ~light)
    inner = ~leaf
    rule_bad = int((leaf & must_split).sum())
    rule_bad += int((inner & (pure | (cnt < rules.min_samples_split)
                              | (d >= rules.max_depth) | light)).sum())
    if not bool(inner.any()):
        return rows, node_bad, rule_bad, 0.0, False
    ii = torch.nonzero(inner)[:, 0]
    node = ids_d[ii]
    chosen = score[ii, t["op"][node].long(), t["feat"][node].long(),
                   t["tbin"][node].long()]
    gap = torch.where(best[ii] > NEG, best[ii] - chosen,
                      torch.zeros_like(chosen))
    gap = torch.where(chosen > NEG, gap, torch.full_like(gap, math.inf))
    for side in ("left", "right"):
        ch = t[side][node].long()
        node_bad += int(((ch < 0) | (ch >= n)).sum())
        ok = (ch >= 0) & (ch < n)
        node_bad += int((t["depth"][ch[ok]] != d + 1).sum())
    moving = inner[slot.clamp(min=0)] & (slot >= 0)
    u = node_of_row[moving]
    f = t["feat"][u].long()
    xb = bins[moving].gather(1, f[:, None])[:, 0].long()
    go_left = predicate(xb, n_num.to(dev).long()[f], t["op"][u].long(),
                        t["tbin"][u].long())
    node_of_row[moving] = torch.where(go_left, t["left"][u].long(),
                                      t["right"][u].long())
    return rows, node_bad, rule_bad, float(gap.max()), True


def judge(tree: dict, bins, stats, n_num, n_cat, n_bins: int, rules: Rules,
          budget_bytes: int = BUDGET_BYTES, block: int | None = None) -> dict:
    """``tree.judge`` of a class tree (numpy fields of its ``n`` nodes),
    each level in blocks of ``block`` nodes (by default as many as
    ``budget_bytes`` holds, ``block_nodes``).  Returns ``node_mismatch``,
    ``gain_gap``, ``rule_violations`` and ``rows_per_node`` as
    ``tree.judge`` does."""
    if rules.kind != "class":
        raise ValueError(f"judges class trees; got kind {rules.kind!r}")
    dev = bins.device
    t = {k: torch.as_tensor(np.asarray(tree[k]), device=dev) for k in TREE_KEYS}
    n = t["feat"].shape[0]
    depth = np.asarray(tree["depth"])
    stats = stats.to(torch.float64)
    if block is None:
        block = block_nodes(bins.shape[1], n_bins, stats.shape[1],
                            budget_bytes)
    node_of_row = torch.zeros(bins.shape[0], dtype=torch.long, device=dev)
    rows_per_node = np.zeros(n, np.int64)
    node_bad = rule_bad = 0
    gain_gap = 0.0
    for d in range(1, int(depth.max()) + 1):
        ids = np.nonzero(depth == d)[0]
        any_inner = False
        for i0 in range(0, len(ids), block):
            part = ids[i0:i0 + block]
            rows, nb, rb, gap, inner = _block(
                bins, stats, n_num, n_cat, n_bins, rules, t,
                torch.as_tensor(part, device=dev), node_of_row, d, n)
            rows_per_node[part] = rows.cpu().numpy()
            node_bad += nb
            rule_bad += rb
            gain_gap = max(gain_gap, gap)
            any_inner |= inner
        if not any_inner:
            break
    return dict(node_mismatch=node_bad, gain_gap=gain_gap,
                rule_violations=rule_bad, rows_per_node=rows_per_node)
