"""Generic split selection (paper Algorithm 1) -- the O(M*N) baseline, in
torch.

Counterpart of ``repro.core.generic``.  For every candidate value the
feature column and the labels are rescanned (one O(M) pass per candidate),
the abstraction the paper compares Superfast Selection against; the tests
use it as an independent oracle for the chosen split.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core import heuristics as H
from repro_torch.core.split import NEG_INF

__all__ = ["generic_best_split_on_feature"]


def generic_best_split_on_feature(xbin, labels, n_num, n_cat, *, n_classes,
                                  n_bins, heuristic="info_gain", min_leaf=1,
                                  device=None):
    """O(M*N) selection on one (binned) feature on ``device`` (``None``
    means CUDA).

    xbin: [M] bin ids of the feature; labels: [M] int class ids.  Every
    bin id is a candidate, and for each one the WHOLE column is rescanned
    (no shared statistics, no prefix sums).  Returns (score, bin, op) as
    0-d tensors: the first maximum over the flat ``[N, 3]`` candidates
    (bin-major, then op LE / GT / EQ).
    """
    dev = resolve_device(device)
    h_fn = H.get(heuristic)
    n_num, n_cat = int(n_num), int(n_cat)
    xbin = torch.as_tensor(xbin, device=dev).to(torch.int32)
    labels = torch.as_tensor(labels, device=dev).long()
    onehot = torch.nn.functional.one_hot(labels, n_classes).to(torch.float32)
    is_num_x = xbin < n_num
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    def agg(mask):
        # one full O(M) scan of the column and the labels
        pos = torch.where(mask[:, None], onehot, 0.0).sum(0)
        neg = torch.where(mask[:, None], 0.0, onehot).sum(0)
        s = h_fn(pos, neg)
        ok = (pos.sum() >= min_leaf) & (neg.sum() >= min_leaf)
        return torch.where(ok, s, neg_inf)

    scores = []
    for cand in range(n_bins):
        s_le = agg(is_num_x & (xbin <= cand)) if cand < n_num else neg_inf
        s_gt = agg(is_num_x & (xbin > cand)) if cand < n_num else neg_inf
        s_eq = (agg(xbin == cand) if n_num <= cand < n_num + n_cat
                else neg_inf)
        scores.append(torch.stack([s_le, s_gt, s_eq]))
    flat = torch.stack(scores).reshape(-1)                  # [N * 3]
    best = torch.argmax(flat)                               # first max
    return (flat[best], (best // 3).to(torch.int32),
            (best % 3).to(torch.int32))
