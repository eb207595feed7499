"""Superfast Selection (paper Algorithms 2 & 4), fully vectorised in torch.

Given the per-node histograms ``H[S, K, B, C]`` (one O(M) pass, see
``histogram.py``), a prefix sum along the bin axis makes EVERY candidate
split an O(C) evaluation:

  * numeric  "<= v" : pos = prefix[b],           neg = tot - pos
  * numeric  ">  v" : pos = tot_num - prefix[b], neg = tot - pos
  * categorical "=" : pos = H[b],                neg = tot - pos

Note "<=" and ">" are NOT complements when categorical / missing values are
present (both comparisons evaluate False on them, paper Table 3), which is
why the paper -- and we -- score both directions.  Missing-bin counts only
ever appear on the negative side, implementing "leave missing untouched".

Two selection rules, kept apart on purpose because they break cross-feature
ties differently (each is held to its own counterpart in ``repro``):

  * ``best_splits`` takes ONE flat first-max argmax over ``[3, K, B]`` per
    slot, op-major, then feature, then bin;
  * ``best_splits_kernel`` takes the split-scan kernel's per-(slot, feature)
    best over ``[3, B]``, then the FIRST feature with the maximum score.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import heuristics as H

__all__ = ["SplitDecision", "best_splits", "best_splits_kernel",
           "candidate_scores",
           "evaluate_predicate", "OP_LE", "OP_GT", "OP_EQ", "NEG_INF"]

OP_LE, OP_GT, OP_EQ = 0, 1, 2
NEG_INF = -3.4e38


class SplitDecision(NamedTuple):
    score: torch.Tensor      # [S] f32, NEG_INF if no valid split
    feat: torch.Tensor       # [S] i32
    bin: torch.Tensor        # [S] i32 threshold/category bin
    op: torch.Tensor         # [S] i32 in {OP_LE, OP_GT, OP_EQ}
    pos_stats: torch.Tensor  # [S, C] statistics of the positive child
    neg_stats: torch.Tensor  # [S, C] statistics of the negative child


def _candidate_stats(hist, n_num, n_cat):
    """Build pos/neg stat tensors for all three candidate families.

    hist: [S, K, B, C];  n_num, n_cat: [K] ints.
    Returns pos, neg of shape [3, S, K, B, C] and validity mask [3, K, B].
    """
    s, k, b, c = hist.shape
    bin_ids = torch.arange(b, dtype=torch.int32, device=hist.device)
    n_num = n_num.to(torch.int32)
    n_cat = n_cat.to(torch.int32)
    is_num = bin_ids[None, :] < n_num[:, None]                      # [K,B]
    is_cat = (bin_ids[None, :] >= n_num[:, None]) & (
        bin_ids[None, :] < (n_num + n_cat)[:, None])                # [K,B]

    tot = hist.sum(dim=2, keepdim=True)                             # [S,K,1,C]
    num_hist = hist * is_num[None, :, :, None]
    prefix = torch.cumsum(num_hist, dim=2)                          # [S,K,B,C]
    tot_num = prefix[:, :, -1:, :]                                  # [S,K,1,C]

    pos = torch.stack([prefix, tot_num - prefix, hist])             # [3,S,K,B,C]
    neg = tot[None] - pos
    valid = torch.stack([is_num, is_num, is_cat])                   # [3,K,B]
    return pos, neg, valid


def candidate_scores(hist, n_num, n_cat, *, heuristic="info_gain",
                     min_leaf=1):
    """Score every candidate: ``score [3, S, K, B]`` (NEG_INF where the
    candidate is invalid or a side is below ``min_leaf``) with its pos/neg
    statistics ``[3, S, K, B, C]``.  A side's count is channel 0 for "sse",
    the channel sum otherwise."""
    h_fn = H.get(heuristic)
    pos, neg, valid = _candidate_stats(hist, n_num, n_cat)
    moment = heuristic == "sse"
    cnt_pos = pos[..., 0] if moment else pos.sum(-1)                # [3,S,K,B]
    cnt_neg = neg[..., 0] if moment else neg.sum(-1)
    score = h_fn(pos, neg)                                          # [3,S,K,B]
    ok = valid[:, None] & (cnt_pos >= min_leaf) & (cnt_neg >= min_leaf)
    return torch.where(ok, score, NEG_INF), pos, neg


def best_splits(hist: torch.Tensor, n_num: torch.Tensor, n_cat: torch.Tensor,
                *, heuristic: str = "info_gain",
                min_leaf: int = 1) -> SplitDecision:
    """Select the best split for every node slot (Algorithm 4, batched).

    hist: [S, K, B, C] statistics; for classification C = #classes and the
    example count of a side is ``stats.sum(-1)``; for regression moments the
    count is channel 0.  ``min_child_weight`` is not a candidate mask here:
    the tree builder applies it to the WINNING split (see
    ``repro.core.split.best_splits`` for why).
    """
    s, k, b, c = hist.shape
    score, pos, neg = candidate_scores(hist, n_num, n_cat,
                                       heuristic=heuristic, min_leaf=min_leaf)

    flat = score.permute(1, 0, 2, 3).reshape(s, 3 * k * b)          # [S, 3KB]
    best = torch.argmax(flat, dim=1)                                # first max
    best_score = flat.gather(1, best[:, None])[:, 0]
    op = (best // (k * b)).to(torch.int32)
    feat = ((best // b) % k).to(torch.int32)
    tbin = (best % b).to(torch.int32)

    def sel(t):
        t = t.permute(1, 0, 2, 3, 4).reshape(s, 3 * k * b, c)
        return t.gather(1, best[:, None, None].expand(s, 1, c))[:, 0]

    return SplitDecision(best_score, feat, tbin, op, sel(pos), sel(neg))


def best_splits_kernel(hist: torch.Tensor, n_num: torch.Tensor,
                       n_cat: torch.Tensor, *, heuristic: str = "info_gain",
                       min_leaf: int = 1) -> SplitDecision:
    """Kernel-backed selection: the split-scan (``kernels.ops.split_scan``)
    gives the best candidate per (slot, feature); the small cross-feature
    argmax happens here.  pos/neg child stats are not materialised (the tree
    builder derives child statistics at the child's own level)."""
    from repro_torch.kernels import ops as kops
    score_kf, bin_kf, op_kf = kops.split_scan(hist, n_num, n_cat,
                                              heuristic=heuristic,
                                              min_leaf=min_leaf)
    s, k = score_kf.shape
    feat = torch.argmax(score_kf, dim=1)                            # first max

    def take(a):
        return a.gather(1, feat[:, None])[:, 0]

    zeros = torch.zeros((s, hist.shape[-1]), dtype=hist.dtype,
                        device=hist.device)
    return SplitDecision(take(score_kf), feat.to(torch.int32), take(bin_kf),
                         take(op_kf), zeros, zeros)


def evaluate_predicate(xbin, n_num_of_feat, op, tbin):
    """Paper Table 3 comparison semantics on bin ids.

    xbin is the example's bin id for the split feature.  Numeric predicates
    are False for categorical/missing bins (their ids are >= n_num); equality
    is False unless the ids match exactly (missing id never equals a
    candidate id).  Broadcasts over leading dims.
    """
    is_numeric = xbin < n_num_of_feat
    le = is_numeric & (xbin <= tbin)
    gt = is_numeric & (xbin > tbin)
    eq = xbin == tbin
    return torch.where(op == OP_LE, le, torch.where(op == OP_GT, gt, eq))
