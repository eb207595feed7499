"""Plain reference of level-wise decision-tree growth (PyTorch, no kernels).

Two uses, one arithmetic:

* ``judge`` reads a tree the program built and recomputes, level by level
  and in float64, what each node must hold: the rows that reach it (routed
  with the paper's Table 3 predicates), its count and label, the best split
  score over every candidate, the score of the split the tree chose, and
  whether the stopping rules allow it to be a leaf or an inner node.
* ``grow`` builds a tree itself from the same pieces, in a dtype of the
  caller's choice.  In a low precision it stands in for the program as the
  benchmark's control, which the judge has to refuse.

Rows carry statistics ``stats [M, C]``: class one-hots (``kind="class"``,
scored by information gain) or Newton moments ``(w, w z, w z^2)``
(``kind="moment"``, scored by the variance gain ``S_l^2 / W_l + S_r^2 /
W_r``, sizes read from the weight channel).

Candidate families over the bin layout (numeric bins, then categorical
bins, then one missing bin): ``<= b`` and ``> b`` over numeric bins only
(categorical and missing rows fail both), ``== b`` over categorical bins.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["Rules", "predicate", "level_hist", "candidate_scores", "judge",
           "grow", "walk", "TREE_KEYS"]

OP_LE, OP_GT, OP_EQ = 0, 1, 2
NEG = float("-inf")
TREE_KEYS = ("feat", "op", "tbin", "label", "count", "depth", "left", "right",
             "leaf")


@dataclasses.dataclass(frozen=True)
class Rules:
    kind: str                    # "class" | "moment"
    max_depth: int
    min_samples_split: int = 2
    min_samples_leaf: int = 1
    min_child_weight: float = 0.0


def predicate(xb, n_num_f, op, tbin):
    numeric = xb < n_num_f
    return torch.where(op == OP_LE, numeric & (xb <= tbin),
                       torch.where(op == OP_GT, numeric & (xb > tbin),
                                   xb == tbin))


def level_hist(bins, stats, slot, n_slots: int, n_bins: int, dtype,
               feat_block: int = 8):
    """``[n_slots, K, B, C]`` sums of ``stats`` over the rows of each slot
    (rows with ``slot < 0`` are left out), accumulated in ``dtype``."""
    m, k = bins.shape
    c = stats.shape[1]
    rows = torch.nonzero(slot >= 0)[:, 0]
    out = torch.zeros((n_slots * k * n_bins, c), dtype=dtype,
                      device=bins.device)
    if rows.numel() == 0:
        return out.view(n_slots, k, n_bins, c)
    s = slot[rows].long()
    st = stats[rows].to(dtype)
    for f0 in range(0, k, feat_block):
        f1 = min(k, f0 + feat_block)
        f = torch.arange(f0, f1, device=bins.device)
        idx = (s[:, None] * k + f[None]) * n_bins + bins[rows, f0:f1].long()
        out.index_add_(0, idx.reshape(-1),
                       st[:, None, :].expand(-1, f1 - f0, c).reshape(-1, c))
    return out.view(n_slots, k, n_bins, c)


def _xlogx_ratio(a, tot):
    """sum_c a_c log(a_c / tot), 0 log 0 = 0."""
    safe_a = torch.where(a > 0, a, torch.ones_like(a))
    safe_t = torch.where(tot > 0, tot, torch.ones_like(tot))
    return torch.where(a > 0, a * (torch.log(safe_a) - torch.log(safe_t)),
                       torch.zeros_like(a)).sum(-1)


def candidate_scores(hist, n_num, n_cat, rules: Rules):
    """``(score [N, 3, K, B], size_pos, size_neg)`` in ``hist``'s dtype;
    ``-inf`` marks a candidate outside its family or with a side under
    ``min_samples_leaf``."""
    n, k, b, c = hist.shape
    bid = torch.arange(b, device=hist.device)
    n_num = n_num.to(hist.device).long()
    n_cat = n_cat.to(hist.device).long()
    is_num = bid[None] < n_num[:, None]                               # [K,B]
    is_cat = (bid[None] >= n_num[:, None]) & (bid[None] < (n_num + n_cat)[:, None])
    tot = hist.sum(2, keepdim=True)
    prefix = torch.cumsum(hist * is_num[None, :, :, None].to(hist.dtype), 2)
    tot_num = prefix[:, :, -1:]
    pos = torch.stack([prefix, tot_num - prefix, hist], 1)          # [N,3,K,B,C]
    neg = tot[:, None] - pos
    if rules.kind == "class":
        size_p, size_n = pos.sum(-1), neg.sum(-1)
        tp, tn = size_p[..., None], size_n[..., None]
        whole = torch.where(size_p + size_n > 0, size_p + size_n,
                            torch.ones_like(size_p))
        score = (_xlogx_ratio(pos, tp) + _xlogx_ratio(neg, tn)) / whole
    else:
        size_p, size_n = pos[..., 0], neg[..., 0]
        one = torch.ones_like(size_p)
        score = (pos[..., 1] ** 2 / torch.where(size_p > 0, size_p, one)
                 + neg[..., 1] ** 2 / torch.where(size_n > 0, size_n, one))
    family = torch.stack([is_num, is_num, is_cat])                  # [3,K,B]
    ok = (family[None] & (size_p >= rules.min_samples_leaf)
          & (size_n >= rules.min_samples_leaf))
    return torch.where(ok, score, torch.full_like(score, NEG)), size_p, size_n


def _node_stats(tot, rules: Rules):
    """(count, label, pure) of each node from its totals ``[N, C]``: a
    class node is pure when one class holds every row, a moment node when
    its weighted squared error is under ``1e-10`` of its weight."""
    if rules.kind == "class":
        cnt = tot.sum(-1)
        return cnt, torch.argmax(tot, -1).to(tot.dtype), tot.max(-1).values == cnt
    w = tot[:, 0]
    safe = torch.where(w > 0, w, torch.ones_like(w))
    sse = tot[:, 2] - tot[:, 1] ** 2 / safe
    return w, tot[:, 1] / safe, sse <= 1e-10 * torch.clamp(w, min=1.0)


def _levels(depth):
    return [np.nonzero(depth == d)[0] for d in range(1, int(depth.max()) + 1)]


def judge(tree: dict, bins, stats, n_num, n_cat, n_bins: int, rules: Rules,
          tol: float = 0.0) -> dict:
    """Hold a built tree (numpy fields of its ``n`` nodes) against the
    reference, in float64.  Returns:

    * ``node_mismatch``: nodes whose count or label is not the reference's
      (class trees; exact), or whose depth / children break the layout;
    * ``label_gap``: the widest gap of a node's label from the reference's
      weighted mean, over the larger of that mean and the median one
      (moment trees);
    * ``gain_gap``: the widest gap of a chosen split's score below the
      best score at its node (class: nats; moment: a share of the best),
      ``inf`` where the chosen split is not a valid candidate;
    * ``rule_violations``: leaves that the stopping rules would split and
      inner nodes that they would stop, each rule met by a margin ``tol``
      (a share of the compared size) so that rounding cannot decide it;
    * ``rows_per_node``: the rows that reach each node (for counting work).
    """
    dev = bins.device
    f64 = torch.float64
    t = {k: torch.as_tensor(np.asarray(tree[k]), device=dev) for k in TREE_KEYS}
    n = t["feat"].shape[0]
    depth = np.asarray(tree["depth"])
    stats = stats.to(f64)
    node_of_row = torch.zeros(bins.shape[0], dtype=torch.long, device=dev)
    rows_per_node = np.zeros(n, np.int64)
    ref_label = np.zeros(n)
    node_bad = rule_bad = 0
    gain_gap = 0.0
    moment = rules.kind == "moment"
    for d, ids in enumerate(_levels(depth), start=1):
        slot_of = torch.full((n,), -1, dtype=torch.long, device=dev)
        ids_d = torch.as_tensor(ids, device=dev)
        slot_of[ids_d] = torch.arange(len(ids), device=dev)
        slot = slot_of[node_of_row]
        rows_per_node[ids] = torch.bincount(slot[slot >= 0],
                                            minlength=len(ids)).cpu().numpy()
        hist = level_hist(bins, stats, slot, len(ids), n_bins, f64)
        tot = hist[:, 0].sum(1)
        cnt, lab, pure = _node_stats(tot, rules)
        pure_strict = pure
        if moment:
            # the program tests purity in float32, where w z^2 - (w z)^2 / w
            # cancels: decide only where that rounding cannot
            w = torch.clamp(tot[:, 0], min=1.0)
            sse = tot[:, 2] - tot[:, 1] ** 2 / torch.where(
                tot[:, 0] > 0, tot[:, 0], torch.ones_like(w))
            slack = 16 * 2.0 ** -24 * tot[:, 2].abs()
            pure = sse <= 1e-10 * w + slack
            pure_strict = sse <= 1e-10 * w - slack
        ref_label[ids] = lab.cpu().numpy()
        leaf = t["leaf"][ids_d] | (t["left"][ids_d] < 0)
        if not moment:
            node_bad += int(((cnt != t["count"][ids_d].to(f64))
                             | (lab != t["label"][ids_d].to(f64))).sum())
        # the best over candidates clearly inside min_samples_leaf; the
        # chosen one looked up among those not clearly outside it
        strict = dataclasses.replace(
            rules, min_samples_leaf=rules.min_samples_leaf * (1.0 + tol))
        score, size_p, size_n = candidate_scores(hist, n_num, n_cat, strict)
        loose = (candidate_scores(hist, n_num, n_cat, dataclasses.replace(
            rules, min_samples_leaf=rules.min_samples_leaf * (1.0 - tol)))[0]
            if tol else score)
        flat = score.reshape(len(ids), -1)
        best, arg = flat.max(1)
        # sizes of the best split's lighter child, for min_child_weight
        child_min = torch.minimum(size_p.reshape(len(ids), -1).gather(1, arg[:, None]),
                                  size_n.reshape(len(ids), -1).gather(1, arg[:, None]))[:, 0]
        margin = 1.0 + tol
        small = (cnt * margin < rules.min_samples_split - 0.5 if moment
                 else cnt < rules.min_samples_split)
        big = (cnt > (rules.min_samples_split - 0.5) * margin if moment
               else cnt >= rules.min_samples_split)
        light = (child_min * margin <= rules.min_child_weight
                 if rules.min_child_weight else torch.zeros_like(pure))
        heavy = (child_min > rules.min_child_weight * margin
                 if rules.min_child_weight else torch.ones_like(pure))
        has_clear = best > NEG
        must_split = (~pure & has_clear & big & (d < rules.max_depth) & heavy)
        rule_bad += int((leaf & must_split).sum())
        inner = ~leaf
        stop_inner = inner & (pure_strict | small | (d >= rules.max_depth)
                              | light)
        rule_bad += int(stop_inner.sum())
        if not bool(inner.any()):
            break
        ii = torch.nonzero(inner)[:, 0]
        node = ids_d[ii]
        chosen = loose[ii, t["op"][node].long(), t["feat"][node].long(),
                       t["tbin"][node].long()]
        gap = best[ii] - chosen
        if moment:
            gap = gap / torch.clamp(best[ii].abs(), min=1e-300)
        gap = torch.where(best[ii] > NEG, gap, torch.zeros_like(gap))
        gap = torch.where(chosen > NEG, gap, torch.full_like(gap, math.inf))
        gain_gap = max(gain_gap, float(gap.max()))
        # layout: children one level down
        for side in ("left", "right"):
            ch = t[side][node].long()
            node_bad += int(((ch < 0) | (ch >= n)).sum())
            ok = (ch >= 0) & (ch < n)
            node_bad += int((t["depth"][ch[ok]] != d + 1).sum())
        # route this level's rows one step down
        at = node_of_row
        moving = inner[slot.clamp(min=0)] & (slot >= 0)
        u = at[moving]
        f = t["feat"][u].long()
        xb = bins[moving].gather(1, f[:, None])[:, 0].long()
        go_left = predicate(xb, n_num.to(dev).long()[f], t["op"][u].long(),
                            t["tbin"][u].long())
        node_of_row[moving] = torch.where(go_left, t["left"][u].long(),
                                          t["right"][u].long())
    out = dict(node_mismatch=node_bad, gain_gap=gain_gap,
               rule_violations=rule_bad, rows_per_node=rows_per_node)
    if moment:
        lab = np.asarray(tree["label"], np.float64)
        scale = np.maximum(np.abs(ref_label), np.median(np.abs(ref_label)))
        scale = np.where(scale > 0, scale, 1.0)
        out["label_gap"] = float((np.abs(lab - ref_label) / scale).max())
    return out


def grow(bins, stats, n_num, n_cat, n_bins: int, rules: Rules, dtype) -> dict:
    """Build a tree level by level, sums and scores in ``dtype``: node ids
    level-contiguous, children allocated in sibling pairs in node order,
    the first best candidate in (op, feature, bin) order.  Returns numpy
    fields of its nodes, the layout ``judge`` reads."""
    dev = bins.device
    m = bins.shape[0]
    st = stats.to(dtype)
    fields = {k: [] for k in TREE_KEYS}
    node_of_row = torch.zeros(m, dtype=torch.long, device=dev)
    level = [0]
    next_free = 1
    d = 1
    while level:
        w = len(level)
        base = level[0]
        slot = node_of_row - base
        slot = torch.where((slot >= 0) & (slot < w), slot, torch.full_like(slot, -1))
        hist = level_hist(bins, st, slot, w, n_bins, dtype)
        cnt, lab, pure = _node_stats(hist[:, 0].sum(1), rules)
        score, size_p, size_n = candidate_scores(hist, n_num, n_cat, rules)
        flat = score.reshape(w, -1)
        best, arg = flat.max(1)
        cmin = torch.minimum(torch.round(size_p.reshape(w, -1).gather(1, arg[:, None])),
                             torch.round(size_n.reshape(w, -1).gather(1, arg[:, None])))[:, 0]
        count = torch.round(cnt.float())
        leaf = (pure | (best == NEG) | (count < rules.min_samples_split)
                | torch.tensor(d >= rules.max_depth, device=dev))
        if rules.min_child_weight:
            leaf = leaf | (cmin <= rules.min_child_weight)
        k, b = hist.shape[1], hist.shape[2]
        op, rem = arg // (k * b), arg % (k * b)
        feat, tbin = rem // b, rem % b
        leaf_h = leaf.cpu().numpy()
        left = np.full(w, -1)
        right = np.full(w, -1)
        split_ids = np.nonzero(~leaf_h)[0]
        left[split_ids] = next_free + 2 * np.arange(len(split_ids))
        right[split_ids] = left[split_ids] + 1
        for key, v in (("feat", np.where(leaf_h, -1, feat.cpu().numpy())),
                       ("op", np.where(leaf_h, -1, op.cpu().numpy())),
                       ("tbin", np.where(leaf_h, -1, tbin.cpu().numpy())),
                       ("label", lab.float().cpu().numpy()),
                       ("count", count.cpu().numpy()),
                       ("depth", np.full(w, d)), ("left", left),
                       ("right", right), ("leaf", leaf_h)):
            fields[key].append(v)
        # route
        inner = torch.as_tensor(~leaf_h, device=dev)
        moving = (slot >= 0) & inner[slot.clamp(min=0)]
        s = slot[moving]
        f = feat[s]
        xb = bins[moving].gather(1, f[:, None])[:, 0].long()
        go = predicate(xb, n_num.to(dev).long()[f], op[s], tbin[s])
        lt = torch.as_tensor(left, device=dev)[s]
        node_of_row[moving] = torch.where(go, lt, lt + 1)
        level = list(range(next_free, next_free + 2 * len(split_ids)))
        next_free += 2 * len(split_ids)
        d += 1
    out = {k: np.concatenate(v) for k, v in fields.items()}
    for k in ("feat", "op", "tbin", "count", "depth", "left", "right"):
        out[k] = out[k].astype(np.int64)
    out["leaf"] = out["leaf"].astype(bool)
    return out


def walk(tree: dict, bins, n_num, steps: int):
    """Leaf label [M] of every row (``tree`` fields as tensors on the rows'
    device), the labels' dtype."""
    dev = bins.device
    node = torch.zeros(bins.shape[0], dtype=torch.long, device=dev)
    n_num = n_num.to(dev).long()
    for _ in range(steps):
        inner = ~tree["leaf"][node] & (tree["left"][node] >= 0)
        f = tree["feat"][node].clamp(min=0).long()
        xb = bins.gather(1, f[:, None])[:, 0].long()
        go = predicate(xb, n_num[f], tree["op"][node].long(),
                       tree["tbin"][node].long())
        child = torch.where(go, tree["left"][node], tree["right"][node]).long()
        node = torch.where(inner, child, node)
    return tree["label"][node]


def visits(tree: dict, bins, n_num, steps: int):
    """Rows that pass through each node on their walk (numpy ``[n]``)."""
    dev = bins.device
    t = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in tree.items()}
    n = t["feat"].shape[0]
    n_num = n_num.to(dev).long()
    node = torch.zeros(bins.shape[0], dtype=torch.long, device=dev)
    seen = torch.bincount(node, minlength=n)
    for _ in range(steps):
        inner = ~t["leaf"][node] & (t["left"][node] >= 0)
        if not bool(inner.any()):
            break
        f = t["feat"][node].clamp(min=0).long()
        xb = bins.gather(1, f[:, None])[:, 0].long()
        go = predicate(xb, n_num[f], t["op"][node].long(), t["tbin"][node].long())
        node = torch.where(go, t["left"][node], t["right"][node]).long()[inner]
        bins = bins[inner]
        seen += torch.bincount(node, minlength=n)
    return seen.cpu().numpy()
