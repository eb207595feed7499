"""Plain reference of Newton boosting on the softmax loss (PyTorch, no
kernels): one tree a class a round, every row in every round.

A round: over the class axis of the class-first ``[C, M]`` raw scores,
``p = softmax(raw)``, ``g = p - onehot(y)``, ``h = max(p (1 - p), 1e-6)``;
class ``c``'s tree fits the Newton target ``z_c = -g_c / h_c`` under the
row weights ``h_c`` (so a leaf's value is ``-sum(g) / sum(h)`` of its
rows), and ``raw_c += lr * tree_c(x)``.  The base scores are the class
log-priors, ``log(max(share, 1e-6))``.  A fit's trees are round-major:
round ``r``'s class ``c`` tree is ``trees[r * C + c]``.

``label_gap`` holds a tree's node values to the float64 Newton step of
their rows.  ``replay`` follows a fit whose trees it is given: it
recomputes every round's scores, gradients and targets from those trees,
in float32 with the operation order of a float32 fit, so the targets it
hands a round's judge are the ones a sound fit grew that round's trees
from.  ``fit``
grows the trees itself (``tree.grow``) with sums and scores in a dtype of
the caller's choice: the control.  ``raw_scores`` adds a fit's trees up
on other rows in a dtype of the caller's choice.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.boost import moment_stats
from portbench.reference.tree import Rules, grow, predicate, walk

__all__ = ["EPS", "base_score", "grad_hess", "label_gap", "replay", "fit",
           "raw_scores"]

EPS = 1e-6


def _onehot(y, n_classes: int):
    """``[C, M]`` float32 class indicators of int labels ``y [M]``."""
    return torch.nn.functional.one_hot(y.long(), n_classes).to(torch.float32).T


def base_score(y, n_classes: int):
    """Class log-priors ``[C]``, float32."""
    share = _onehot(y, n_classes).mean(dim=1)
    return torch.log(torch.clamp(share, EPS, 1.0))


def grad_hess(raw, y, n_classes: int):
    """``(g, h)``, both ``[C, M]``, at the class-first scores ``raw``."""
    p = torch.softmax(raw, dim=0)
    return p - _onehot(y, n_classes), torch.clamp(p * (1.0 - p), min=EPS)


def _tensors(tree: dict, dev):
    return {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in tree.items()}


def _leaves(trees, bins, n_num, steps: int):
    """``[C, M]`` leaf values of one round's class-trees."""
    dev = bins.device
    return torch.stack([walk(_tensors(t, dev), bins, n_num, steps)
                        for t in trees])


def label_gap(tree: dict, bins, n_num, z, w, steps: int) -> float:
    """The widest gap of a node's value from the float64 Newton step of
    the rows that reach it, ``sum(w z) / sum(w)``, over the larger of that
    step and ``sum(w |z|) / sum(w)``, the size of the terms it sums.  A
    class-tree's step is often near 0 by cancellation (a class whose
    gradients sum to about 0 gets a one-leaf tree of value about 0), and
    a share of such a value would measure only its rounding; the terms'
    size bounds what a sum of them can lose to rounding."""
    dev = bins.device
    t = _tensors(tree, dev)
    n = t["feat"].shape[0]
    n_num = n_num.to(dev).long()
    f64 = torch.float64
    terms = torch.stack([w.to(f64), (w * z).to(f64), (w * z.abs()).to(f64)], 1)
    sums = torch.zeros((n, 3), dtype=f64, device=dev)
    node = torch.zeros(bins.shape[0], dtype=torch.long, device=dev)
    sums.index_add_(0, node, terms)
    for _ in range(steps - 1):
        inner = ~t["leaf"][node] & (t["left"][node] >= 0)
        if not bool(inner.any()):
            break
        f = t["feat"][node].clamp(min=0).long()
        xb = bins.gather(1, f[:, None])[:, 0].long()
        go = predicate(xb, n_num[f], t["op"][node].long(), t["tbin"][node].long())
        node = torch.where(go, t["left"][node], t["right"][node]).long()
        node, bins, terms = node[inner], bins[inner], terms[inner]
        sums.index_add_(0, node, terms)
    seen = sums[:, 0] > 0
    safe = torch.where(seen, sums[:, 0], torch.ones_like(sums[:, 0]))
    step = sums[:, 1] / safe
    scale = torch.maximum(step.abs(), sums[:, 2] / safe)
    gap = (t["label"].to(f64) - step).abs() / torch.where(
        scale > 0, scale, torch.ones_like(scale))
    return float(torch.where(seen, gap, torch.zeros_like(gap)).max())


def replay(trees, bins, y, n_num, *, n_classes: int, lr: float, steps: int,
           visit=None):
    """Walk a fit's rounds from its trees; returns the last ``[C, M]`` raw
    scores.  ``visit(r, z, h)`` is called with round ``r``'s ``[C, M]``
    Newton targets and weights before the round's trees are added."""
    dev = bins.device
    m = bins.shape[0]
    raw = base_score(y, n_classes)[:, None].expand(n_classes, m)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
    for r in range(len(trees) // n_classes):
        g, h = grad_hess(raw, y, n_classes)
        if visit is not None:
            visit(r, -g / h, h)
        round_trees = trees[r * n_classes:(r + 1) * n_classes]
        raw = raw + lr_t * _leaves(round_trees, bins, n_num, steps)
    return raw


def fit(bins, y, n_num, n_cat, n_bins: int, *, n_classes: int, rounds: int,
        lr: float, rules: Rules, dtype) -> list:
    """Grow ``rounds`` rounds of class-trees, round-major, with sums and
    scores in ``dtype``; the rounds' scores stay in float32."""
    dev = bins.device
    m = bins.shape[0]
    raw = base_score(y, n_classes)[:, None].expand(n_classes, m)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
    trees = []
    for _ in range(rounds):
        g, h = grad_hess(raw, y, n_classes)
        z = -g / h
        round_trees = [grow(bins, moment_stats(z[c], h[c], dtype), n_num,
                            n_cat, n_bins, rules, dtype)
                       for c in range(n_classes)]
        trees.extend(round_trees)
        raw = raw + lr_t * _leaves(round_trees, bins, n_num,
                                   rules.max_depth).to(torch.float32)
    return trees


def raw_scores(trees, bins, n_num, base, *, n_classes: int, lr: float,
               steps: int, dtype):
    """``[C, M]`` raw scores of a fit on ``bins``: ``base [C]`` plus ``lr``
    times the sum of every round's leaf values, summed in ``dtype``."""
    m = bins.shape[0]
    raw = base.to(dtype)[:, None].expand(n_classes, m)
    for r in range(len(trees) // n_classes):
        leaves = _leaves(trees[r * n_classes:(r + 1) * n_classes], bins,
                         n_num, steps)
        raw = raw + (lr * leaves.to(dtype)).to(dtype)
    return raw
