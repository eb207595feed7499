"""Histogram construction: the one-pass statistics collection of Superfast
Selection (paper Algorithm 4 lines 2-9), batched over nodes and features.

Counterpart of ``repro.core.histogram``.  ``node_histogram`` produces
``H[S, K, B, C]`` where ``S`` is the number of node *slots* in the current
level chunk, ``K`` features, ``B`` bins and ``C`` statistics channels (class
counts for classification; ``(count, sum_y, sum_y2)`` moments for variance
regression; 2 pseudo-classes for the paper's regression label-split).

Backends:
  * ``segment`` - masked ``index_add_`` (the plain version of kernel A)
  * ``onehot``  - one-hot x stats product in full fp32
  * ``kernel``  - ``kernels.ops.histogram``: the hand-written CUDA kernel on
                  a CUDA tensor, its plain version on a CPU tensor (the
                  reference calls this backend ``pallas``)

``node_histogram_smaller_child`` scatters statistics only for the smaller
child of every sibling pair (packed pair axis); the co-child is derived as
``H_parent - H_small``.  ``node_histogram_sibling_fused`` does both in one
call, and on the ``kernel`` backend the derivation and the pair interleave
run in the kernel's epilogue; given no ``compute`` mask it also picks the
smaller children itself (``smaller_child_mask``'s rule: in the kernel's
``pairs`` launch on the ``kernel`` backend).  All three take an optional
``weights`` [M] channel: rows accumulate ``w[i] * stats[i]``.

``node_histogram_stacked`` / ``node_histogram_smaller_child_stacked`` /
``node_histogram_sibling_fused_stacked`` are the multiclass build's
class-stacked twins (the reference vmaps the single functions over a
leading class axis): ``L`` lanes of stats / slots / weights over the shared
bins, one kernel launch on the ``kernel`` backend, a loop over lanes on the
others.

Exactness: integer-count channels are exact in f32 below 2**24 examples in
any summation order, so subtraction and every backend agree bit for bit on
classification; float channels agree to accumulation-order tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.histogram import (histogram_plain, interleave_pairs,
                                           pair_slot_map, slot_counts,
                                           smaller_children)

__all__ = ["node_histogram", "node_histogram_smaller_child",
           "node_histogram_sibling_fused", "node_histogram_stacked",
           "node_histogram_smaller_child_stacked",
           "node_histogram_sibling_fused_stacked", "smaller_child_mask",
           "class_stats", "moment_stats", "BACKENDS"]


def class_stats(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """[M] int labels -> [M, C] one-hot float32 statistic rows."""
    return torch.nn.functional.one_hot(labels.long(), n_classes).to(torch.float32)


def moment_stats(y: torch.Tensor) -> torch.Tensor:
    """[M] float targets -> [M, 3] (1, y, y^2) moment rows."""
    y = y.to(torch.float32)
    return torch.stack([torch.ones_like(y), y, y * y], dim=-1)


def _segment_backend(bins, stats, slot, num_slots, n_bins, weights=None):
    return histogram_plain(bins, stats, slot, num_slots=num_slots,
                           n_bins=n_bins, weights=weights)


def _onehot_backend(bins, stats, slot, num_slots, n_bins, weights=None):
    m, k = bins.shape
    if weights is not None:
        stats = stats * weights[:, None].to(torch.float32)
    c = stats.shape[-1]
    keep = (slot >= 0) & (slot < num_slots)
    idx = torch.where(keep[:, None], slot[:, None] * n_bins + bins,
                      num_slots * n_bins).long()                    # [M,K]
    oh = torch.nn.functional.one_hot(idx, num_slots * n_bins + 1)[..., :-1]
    h = torch.einsum("mks,mc->ksc", oh.to(torch.float32), stats)
    return h.reshape(k, num_slots, n_bins, c).permute(1, 0, 2, 3).contiguous()


def _kernel_backend(bins, stats, slot, num_slots, n_bins, weights=None):
    return kops.histogram(bins, stats, slot, num_slots=num_slots,
                          n_bins=n_bins, weights=weights)


_BACKENDS = {
    "segment": _segment_backend,
    "onehot": _onehot_backend,
    "kernel": _kernel_backend,
}
BACKENDS = tuple(_BACKENDS)


def node_histogram(bins, stats, slot, *, num_slots: int, n_bins: int,
                   backend: str = "segment", weights=None) -> torch.Tensor:
    """Accumulate per-(node-slot, feature, bin) statistic rows.

    Args:
      bins:  [M, K] int32 bin ids (output of core.binning).
      stats: [M, C] float32 statistic rows per example.
      slot:  [M] int32 node slot in [0, num_slots) or -1 if the example's
             node is not in the current chunk (finalised leaf / other chunk);
             such rows are dropped.
      weights: optional [M] float32 per-example weight channel.
    Returns:
      H: [num_slots, K, n_bins, C] float32.
    """
    return _BACKENDS[backend](bins, stats, slot, num_slots, n_bins, weights)


def smaller_child_mask(slot, num_slots, reduce=None):
    """[..., S] "scatter me" mask of sibling subtraction from the rows of
    ``slot`` (``smaller_children``; rows outside ``[0, S)`` are not
    counted).  ``reduce`` (the psum over the data axes of a sharded build)
    makes the counts global, so every data shard picks the same child."""
    cnt = slot_counts(slot, num_slots)
    return smaller_children(cnt if reduce is None else reduce(cnt))


def _explicit_pairs(compute):
    """The fused kernel call's ``slot_map`` / ``side`` for a ``[...,
    num_slots]`` compute mask; none for None (a ``pairs`` launch)."""
    if compute is None:
        return {}
    return dict(slot_map=pair_slot_map(compute), side=compute[..., 0::2])


def node_histogram_smaller_child(bins, stats, slot, compute, *,
                                 num_slots: int, n_bins: int,
                                 backend: str = "segment",
                                 weights=None) -> torch.Tensor:
    """Scatter statistics only for the per-pair "compute me" child slots.

    ``compute`` is a [num_slots] bool mask selecting exactly one slot of each
    sibling pair ``(2j, 2j+1)``; the computed child of pair ``j`` lands in
    packed slot ``j``.  Returns H_small [num_slots // 2, K, n_bins, C].
    """
    if num_slots % 2:
        raise ValueError("pair packing needs an even slot count")
    slot_map = pair_slot_map(compute)
    if backend == "kernel":
        return kops.histogram(bins, stats, slot, num_slots=num_slots // 2,
                              n_bins=n_bins, slot_map=slot_map,
                              weights=weights)
    packed = torch.where(slot >= 0,
                         slot_map[slot.clamp(0, num_slots - 1).long()], -1)
    return _BACKENDS[backend](bins, stats, packed, num_slots // 2, n_bins,
                              weights)


def node_histogram_sibling_fused(bins, stats, slot, compute, phist_pairs, *,
                                 num_slots: int, n_bins: int,
                                 backend: str = "kernel",
                                 weights=None) -> torch.Tensor:
    """Smaller-child scatter + sibling derivation, in one call.

    ``phist_pairs`` [num_slots//2, K, B, C] holds each sibling pair's parent
    histogram row.  Returns the FULL [num_slots, K, B, C] child histogram:
    the computed child's block is the packed scatter, its sibling is
    ``H_parent - H_small``.  On the ``kernel`` backend the subtraction and
    the interleave run in the kernel's epilogue; other backends subtract and
    interleave with tensor ops.  ``compute`` None: the computed children
    are ``smaller_child_mask(slot, num_slots)``'s, which the ``kernel``
    backend picks inside its launch.
    """
    if num_slots % 2:
        raise ValueError("pair packing needs an even slot count")
    if backend == "kernel":
        return kops.histogram(bins, stats, slot, num_slots=num_slots // 2,
                              n_bins=n_bins, phist=phist_pairs,
                              weights=weights, **_explicit_pairs(compute))
    if compute is None:
        compute = smaller_child_mask(slot, num_slots)
    small_is_left = compute[0::2]                            # [pairs]
    h_small = node_histogram_smaller_child(bins, stats, slot, compute,
                                           num_slots=num_slots, n_bins=n_bins,
                                           backend=backend, weights=weights)
    return interleave_pairs(h_small, phist_pairs, small_is_left)


def _lane(x, i):
    return None if x is None else x[i]


def node_histogram_stacked(bins, stats, slot, *, num_slots: int,
                           n_bins: int, backend: str = "segment",
                           weights=None) -> torch.Tensor:
    """``node_histogram`` of every lane: ``stats [L, M, C]``, ``slot [L,
    M]``, optional ``weights [L, M]`` over the shared ``bins [M, K]`` ->
    ``[L, num_slots, K, n_bins, C]``."""
    if backend == "kernel":
        return kops.histogram_stacked(bins, stats, slot, num_slots=num_slots,
                                      n_bins=n_bins, weights=weights)
    return torch.stack([
        node_histogram(bins, stats[i], slot[i], num_slots=num_slots,
                       n_bins=n_bins, backend=backend,
                       weights=_lane(weights, i))
        for i in range(stats.shape[0])])


def node_histogram_smaller_child_stacked(bins, stats, slot, compute, *,
                                         num_slots: int, n_bins: int,
                                         backend: str = "segment",
                                         weights=None) -> torch.Tensor:
    """``node_histogram_smaller_child`` of every lane: ``compute [L,
    num_slots]`` -> ``[L, num_slots // 2, K, B, C]`` (the sharded multiclass
    build, which reduces the packed block before it subtracts)."""
    if num_slots % 2:
        raise ValueError("pair packing needs an even slot count")
    if backend == "kernel":
        return kops.histogram_stacked(
            bins, stats, slot, num_slots=num_slots // 2, n_bins=n_bins,
            slot_map=pair_slot_map(compute), weights=weights)
    return torch.stack([
        node_histogram_smaller_child(bins, stats[i], slot[i], compute[i],
                                     num_slots=num_slots, n_bins=n_bins,
                                     backend=backend,
                                     weights=_lane(weights, i))
        for i in range(stats.shape[0])])


def node_histogram_sibling_fused_stacked(bins, stats, slot, compute,
                                         phist_pairs, *, num_slots: int,
                                         n_bins: int,
                                         backend: str = "kernel",
                                         weights=None) -> torch.Tensor:
    """``node_histogram_sibling_fused`` of every lane: ``compute [L,
    num_slots]`` (or None: each lane's own smaller children),
    ``phist_pairs [L, num_slots//2, K, B, C]`` -> ``[L, num_slots, K, B,
    C]``."""
    if num_slots % 2:
        raise ValueError("pair packing needs an even slot count")
    if backend == "kernel":
        return kops.histogram_stacked(
            bins, stats, slot, num_slots=num_slots // 2, n_bins=n_bins,
            phist=phist_pairs, weights=weights, **_explicit_pairs(compute))
    return torch.stack([
        node_histogram_sibling_fused(bins, stats[i], slot[i],
                                     _lane(compute, i), phist_pairs[i],
                                     num_slots=num_slots,
                                     n_bins=n_bins, backend=backend,
                                     weights=_lane(weights, i))
        for i in range(stats.shape[0])])
