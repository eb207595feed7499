"""Torch oracles for the kernels (the ``ref.py`` contract), used by the
tests only: straight-line tensor code with no tiling, counterparts of
``repro.kernels.ref``.

``histogram_ref`` is the one-hot x stats product, independent of both the
CUDA kernel and its ``index_add_`` plain version.  ``split_scan_ref`` is the
``[3, S, K, B, C]`` tensor form, which is also the split-scan kernel's plain
version.  ``linear_scan_loop`` is the recurrence as a loop over positions
(the port's ``_scan_linear_recurrence`` before the op), whose autograd the
linear scan's backward is held against.  ``random_tree`` makes the walk
kernel's seeded trees, whose labels are held against the plain walk's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.split import candidate_scores
from repro_torch.kernels.split_scan import split_scan_plain as split_scan_ref

__all__ = ["histogram_ref", "sibling_ref", "split_scan_ref", "best_is_unique",
           "linear_scan_loop", "random_tree"]


def histogram_ref(bins, stats, slot, *, num_slots, n_bins, weights=None):
    """H[S, K, B, C] += w[i] * stats[i] at (slot[i], k, bins[i,k]), as a
    one-hot product in full fp32."""
    m, k = bins.shape
    c = stats.shape[-1]
    if weights is not None:
        stats = stats * weights[:, None].to(torch.float32)
    # slots < 0 or >= num_slots land in a last, discarded one-hot column
    idx = torch.where(slot[:, None] < 0, num_slots * n_bins,
                      slot[:, None] * n_bins + bins).long()       # [M,K]
    idx = idx.clamp(max=num_slots * n_bins)
    oh = torch.nn.functional.one_hot(idx, num_slots * n_bins + 1)[..., :-1]
    h = torch.einsum("mks,mc->ksc", oh.to(torch.float32), stats)
    return h.reshape(k, num_slots, n_bins, c).permute(1, 0, 2, 3).contiguous()


def sibling_ref(bins, stats, slot, slot_map, phist, side, *, num_pairs,
                n_bins, weights=None):
    """Packed smaller-child scatter (slots remapped through ``slot_map``, -1
    drops the row), co-child derived as ``phist - H_small``, pairs
    interleaved with ``side[j] != 0`` meaning the computed child is left."""
    n_in = slot_map.shape[0]
    packed = torch.where((slot >= 0) & (slot < n_in),
                         slot_map[slot.clamp(0, n_in - 1).long()], -1)
    h_small = histogram_ref(bins, stats, packed, num_slots=num_pairs,
                            n_bins=n_bins, weights=weights)
    h_der = phist - h_small
    sl = (side != 0)[:, None, None, None]
    k = bins.shape[1]
    return torch.stack([torch.where(sl, h_small, h_der),
                        torch.where(sl, h_der, h_small)],
                       dim=1).reshape(2 * num_pairs, k, n_bins,
                                      stats.shape[-1])


def best_is_unique(hist, n_num, n_cat, *, heuristic="info_gain", min_leaf=1,
                   rel=1e-5):
    """[S, K] bool: the best candidate of each (slot, feature) beats its
    runner-up by more than ``rel * (|best| + 1)``.  Where it does not, two
    correct scans may pick different (bin, op) within rounding."""
    s, k, b, _ = hist.shape
    score, _, _ = candidate_scores(hist, n_num, n_cat, heuristic=heuristic,
                                   min_leaf=min_leaf)
    top = score.permute(1, 2, 0, 3).reshape(s, k, 3 * b).topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]) > rel * (top[..., 0].abs() + 1)


def linear_scan_loop(a, b):
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1 of ``[B, T, D]``, ``h_{-1} =
    0``, one position at a time and differentiable (its backward is
    autograd's)."""
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def random_tree(seed, *, k, n_bins, depth, slots, leaf_p=0.15, root_count=200):
    """Seeded WALK_FIELDS ``[slots]`` CPU tensors of one tree and its node
    count: nodes in level order from the root, each interior with a random
    feature, op (<=, > or =) and threshold in ``[0, n_bins)``, children's
    counts splitting the parent's; a node is a leaf at ``depth`` and with
    probability ``leaf_p`` above it, and one leaf in four keeps ``leaf``
    false with no children (the padding slots' form).  Slots past the nodes
    are inert padding."""
    rng = np.random.default_rng(seed)
    i32 = dict(dtype=np.int32)
    f = dict(feat=np.full(slots, -1, **i32), op=np.full(slots, -1, **i32),
             tbin=np.full(slots, -1, **i32),
             label=np.zeros(slots, np.float32), count=np.zeros(slots, **i32),
             left=np.full(slots, -1, **i32), right=np.full(slots, -1, **i32),
             leaf=np.zeros(slots, bool))
    f["count"][0] = root_count
    level, d, n = [0], 1, 1
    while level:
        nxt = []
        for node in level:
            f["label"][node] = rng.standard_normal()
            if d >= depth or n + 2 > slots or rng.random() < leaf_p:
                f["leaf"][node] = rng.random() >= 0.25
                continue
            f["feat"][node] = rng.integers(0, k)
            f["op"][node] = rng.integers(0, 3)
            f["tbin"][node] = rng.integers(0, n_bins)
            c = int(f["count"][node])
            f["left"][node], f["right"][node] = n, n + 1
            f["count"][n] = rng.integers(0, c + 1)
            f["count"][n + 1] = c - f["count"][n]
            nxt += [n, n + 1]
            n += 2
        level, d = nxt, d + 1
    return {name: torch.from_numpy(v) for name, v in f.items()}, n
