"""Split heuristics, each O(C) per candidate (paper Algorithm 3 generalised).

Every function maps ``(pos, neg)`` class-count tensors of shape ``[..., C]``
to a score of shape ``[...]`` where HIGHER is better.  They are plain
broadcastable torch ops, so Superfast Selection scores *all* candidates of
*all* features of *all* active nodes in one shot.  The operation order (the
``_safe_log`` guards, the ``where`` masks) is that of
``repro.core.heuristics``; the CUDA split-scan kernel
(``csrc/split_scan.cu``) evaluates the same formulas in the same order.

``info_gain`` is the paper's simplified information gain (Eq. 2 /
Algorithm 3): the (negated) conditional entropy -H(T|a); H(T) is constant
across candidates so it cancels.
"""
from __future__ import annotations

import torch

__all__ = ["info_gain", "gini", "chi_square", "sse_gain", "get", "HEURISTICS",
           "HEURISTIC_CODES"]


def _safe_log(x):
    return torch.log(torch.where(x > 0, x, 1.0))


def info_gain(pos, neg):
    """Paper Eq. 2:  1/M * [ sum_i p_i log(p_i / tot_p) + sum_i n_i log(n_i / tot_n) ]."""
    tot_p = pos.sum(-1, keepdim=True)
    tot_n = neg.sum(-1, keepdim=True)
    tot = tot_p + tot_n
    tot = torch.where(tot > 0, tot, 1.0)
    term_p = torch.where(pos > 0, pos * (_safe_log(pos) - _safe_log(tot_p)), 0.0)
    term_n = torch.where(neg > 0, neg * (_safe_log(neg) - _safe_log(tot_n)), 0.0)
    return (term_p.sum(-1) + term_n.sum(-1)) / tot[..., 0]


def gini(pos, neg):
    """Negated weighted Gini impurity of the two children."""
    tot_p = pos.sum(-1)
    tot_n = neg.sum(-1)
    tot = torch.where(tot_p + tot_n > 0, tot_p + tot_n, 1.0)
    sp = (pos * pos).sum(-1) / torch.where(tot_p > 0, tot_p, 1.0)
    sn = (neg * neg).sum(-1) / torch.where(tot_n > 0, tot_n, 1.0)
    # weighted impurity = tot_p/tot*(1 - sp/tot_p) + ... ; dropping the
    # constant 1 and sign-flipping gives (sp + sn) / tot to MAXIMISE.
    return (sp + sn) / tot


def chi_square(pos, neg):
    """Pearson chi-square statistic of the 2xC contingency table."""
    tot_p = pos.sum(-1, keepdim=True)
    tot_n = neg.sum(-1, keepdim=True)
    col = pos + neg
    tot = torch.where(tot_p + tot_n > 0, tot_p + tot_n, 1.0)
    exp_p = tot_p * col / tot
    exp_n = tot_n * col / tot
    dp = torch.where(exp_p > 0, (pos - exp_p) ** 2 / torch.where(exp_p > 0, exp_p, 1.0), 0.0)
    dn = torch.where(exp_n > 0, (neg - exp_n) ** 2 / torch.where(exp_n > 0, exp_n, 1.0), 0.0)
    return dp.sum(-1) + dn.sum(-1)


def sse_gain(pos, neg):
    """Variance / SSE criterion for regression (paper Eq. 3, sign-flipped).

    Here the last axis holds moment statistics ``(count, sum_y, sum_y2)``
    instead of class counts.  Maximising ``sum^2/cnt`` on both sides is
    equivalent to minimising the post-split SSE (the sum_y2 terms cancel).
    """
    cnt_p, sum_p = pos[..., 0], pos[..., 1]
    cnt_n, sum_n = neg[..., 0], neg[..., 1]
    sp = sum_p * sum_p / torch.where(cnt_p > 0, cnt_p, 1.0)
    sn = sum_n * sum_n / torch.where(cnt_n > 0, cnt_n, 1.0)
    return sp + sn


HEURISTICS = {
    "info_gain": info_gain,
    "gini": gini,
    "chi_square": chi_square,
    "sse": sse_gain,
}

# the integer code the split-scan kernel takes for each heuristic
HEURISTIC_CODES = {name: i for i, name in enumerate(HEURISTICS)}


def get(name):
    if callable(name):
        return name
    try:
        return HEURISTICS[name]
    except KeyError:
        raise ValueError(f"unknown heuristic {name!r}; have {list(HEURISTICS)}") from None
