"""Torch oracles for the kernels (the ``ref.py`` contract), used by the
tests only: straight-line tensor code with no tiling, counterparts of
``repro.kernels.ref``.

``histogram_ref`` is the one-hot x stats product, independent of both the
CUDA kernel and its ``index_add_`` plain version.  ``split_scan_ref`` is the
``[3, S, K, B, C]`` tensor form, which is also the split-scan kernel's plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.core.split import candidate_scores
from repro_torch.kernels.split_scan import split_scan_plain as split_scan_ref

__all__ = ["histogram_ref", "sibling_ref", "split_scan_ref", "best_is_unique"]


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
