"""Kernel A, the node / feature / bin histogram: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``repro.kernels.histogram.histogram_pallas``.  For every row
whose slot (after the optional ``slot_map`` remap, where -1 drops the row)
lies in ``[0, num_slots)``, add ``w[i] * stats[i, :]`` at
``H[slot, k, bins[i, k], :]`` for every feature ``k``.  Five modes, all in
one kernel: plain; ``weights``; ``slot_map``; fused sibling derivation
(``phist`` / ``side``), which returns the interleaved ``[2P, K, B, C]``
child block with the co-child derived as ``phist - H_small``; and
``pairs``, the fused mode given ``phist`` alone: ``slot`` holds the raw
child slots ``[0, 2P)`` and the launch picks each pair's computed child
itself (``smaller_children``: the child with fewer rows, the left one on
a tie), with the same ``H`` as a fused call given that choice.  The
class-stacked mode (``histogram_stacked_cuda``) is the reference's
``jax.vmap`` over the kernel written out: ``L`` lanes of stats / slots /
weights over one shared ``bins``, one launch, lane ``l`` equal to a
one-lane launch on its inputs.

``histogram_cuda`` launches ``csrc/histogram.cu`` (rows grouped by slot,
then one shared-memory histogram per slot chunk and feature tile, every
output cell written once, the fused pair block included; the source says
what bounds it).  Integer values add as int32; any other launch adds
every value in int64 fixed point, so the same inputs give the same ``H``
bit for bit on every launch.  ``histogram_plain`` is the same function as
a masked ``index_add_``: the CPU path and the kernel's yardstick on the
card.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, _checks
from repro_torch.kernels._checks import is_fake, need, stream_of

__all__ = ["histogram_cuda", "histogram_plain", "histogram_stacked_cuda",
           "histogram_stacked_plain", "interleave_pairs", "remap_slots",
           "slot_counts", "smaller_children", "pair_slot_map", "MODES"]

MODES = ("plain", "weights", "slot_map", "fused", "stacked", "pairs")


def slot_counts(slot, num_slots):
    """Rows per slot: ``[..., M]`` slot ids -> ``[..., num_slots]`` float32
    counts.  Ids outside ``[0, num_slots)`` fall into a spill bucket per
    leading index, which is cut off."""
    s = num_slots
    lead = slot.shape[:-1]
    n = math.prod(lead)
    keep = (slot >= 0) & (slot < s)
    base = torch.arange(n, device=slot.device).view(*lead, 1) * (s + 1)
    cnt = torch.zeros(n * (s + 1), dtype=torch.float32, device=slot.device)
    cnt.index_add_(0, (torch.where(keep, slot, s) + base).reshape(-1).long(),
                   torch.ones(slot.numel(), dtype=torch.float32,
                              device=slot.device))
    return cnt.view(*lead, s + 1)[..., :s]


def smaller_children(counts):
    """The "scatter me" mask of sibling subtraction: ``[..., 2P]`` rows per
    child slot -> ``[..., 2P]`` bool, per sibling pair ``(2j, 2j + 1)``
    the child with fewer routed rows, the left one on a tie
    (``csrc/histogram.cu``'s ``plan_kernel`` makes the same choice in a
    ``pairs`` launch)."""
    small_is_left = counts[..., 0::2] <= counts[..., 1::2]
    return torch.stack([small_is_left, ~small_is_left], dim=-1).reshape(
        counts.shape)


def pair_slot_map(compute):
    """``[..., 2P]`` "scatter me" mask (one child of each pair) -> the
    int32 slot map of the pair block: the computed child of pair ``j`` ->
    ``j``, its sibling -> -1."""
    ids = torch.arange(compute.shape[-1], dtype=torch.int32,
                       device=compute.device)
    return torch.where(compute, ids // 2, -1)


def remap_slots(slot, slot_map):
    """Raw slot ids through the ``[S_in]`` table; out-of-range ids and -1
    entries drop the row (-1).  Clamped gather, as the reference's."""
    n_in = slot_map.shape[0]
    mapped = slot_map.to(slot.dtype)[slot.clamp(0, n_in - 1).long()]
    return torch.where((slot >= 0) & (slot < n_in), mapped, -1)


def interleave_pairs(h_small, phist, side):
    """Pair j of the packed block -> full slots 2j | 2j+1; ``side[j] != 0``
    puts the computed child on the left."""
    derived = phist - h_small
    sl = (side != 0)[:, None, None, None]
    p, k, b, c = h_small.shape
    return torch.stack([torch.where(sl, h_small, derived),
                        torch.where(sl, derived, h_small)],
                       dim=1).reshape(2 * p, k, b, c)


def histogram_plain(bins, stats, slot, *, num_slots, n_bins, weights=None,
                    slot_map=None, phist=None, side=None):
    """Masked ``index_add_`` form of the kernel (every mode; ``phist``
    without ``side`` is ``pairs``), summed in the dtype of ``stats``
    (float32 on the main path; the tests also take a float64 sum as the
    truth the kernel's float path is held to).

    Static shapes: a dropped row (slot outside ``[0, num_slots)``) adds
    into a spill slot ``num_slots`` of an ``[S + 1, ...]`` accumulator,
    which is cut off; each kept cell still adds its rows in row order.
    The spilled rows keep their bins (clamped into range), so they spread
    over the spill slot's cells instead of piling onto one."""
    m, k = bins.shape
    c = stats.shape[-1]
    if phist is not None and side is None:
        _no_pairs_map(slot_map)
        compute = smaller_children(slot_counts(slot, 2 * num_slots))
        slot_map, side = pair_slot_map(compute), compute[..., 0::2]
    if slot_map is not None:
        slot = remap_slots(slot, slot_map)
    if weights is not None:
        stats = stats * weights[:, None].to(stats.dtype)
    keep = (slot >= 0) & (slot < num_slots)
    slot = torch.where(keep, slot, num_slots)
    feat = torch.arange(k, device=bins.device)
    idx = ((slot.long()[:, None] * k + feat) * n_bins
           + torch.where(keep[:, None], bins,
                         bins.clamp(0, n_bins - 1)).long())      # [M, K]
    h = torch.zeros(((num_slots + 1) * k * n_bins, c), dtype=stats.dtype,
                    device=bins.device)
    h.index_add_(0, idx.reshape(-1),
                 stats[:, None, :].expand(-1, k, -1).reshape(-1, c))
    h = h[:num_slots * k * n_bins].view(num_slots, k, n_bins, c)
    return h if phist is None else interleave_pairs(h, phist, side)


def histogram_stacked_plain(bins, stats, slot, *, num_slots, n_bins,
                            weights=None, slot_map=None, phist=None,
                            side=None):
    """The class-stacked histogram as a loop over lanes: lane ``l`` is
    ``histogram_plain`` of ``stats[l]``, ``slot[l]`` (and ``weights[l]``,
    ``slot_map[l]``, ``phist[l]``, ``side[l]``) over the shared ``bins``.
    Returns ``[L, S, K, B, C]`` (fused and pairs: ``[L, 2P, K, B, C]``)."""
    def lane(x, i):
        return None if x is None else x[i]
    return torch.stack([
        histogram_plain(bins, stats[i], slot[i], num_slots=num_slots,
                        n_bins=n_bins, weights=lane(weights, i),
                        slot_map=lane(slot_map, i), phist=lane(phist, i),
                        side=lane(side, i))
        for i in range(stats.shape[0])])


def _no_pairs_map(slot_map):
    if slot_map is not None:
        raise ValueError("a pairs call (phist without side) chooses the "
                         "computed children itself: it takes no slot_map")


def _launch(bins, stats, slot, lanes, *, num_slots, n_bins, weights,
            slot_map, phist, side):
    """One launch of the CUDA histogram over ``lanes`` row blocks that share
    ``bins`` (``lanes == 0``: the unstacked shapes).  Returns the output
    and the modes it counts under: none when no kernel ran (on fake
    tensors none does: the output is empty and the launch hook hears of
    the launch)."""
    dev = bins.device
    fake = is_fake(bins)
    stream = 0 if fake else stream_of(dev)
    m, k = bins.shape
    lead = (lanes,) if lanes else ()
    c = stats.shape[-1] if stats.dim() == len(lead) + 2 else -1
    p_bins = need(bins, "bins", torch.int32, (m, k), dev)
    p_stats = need(stats, "stats", torch.float32, lead + (m, c), dev)
    p_slot = need(slot, "slot", torch.int32, lead + (m,), dev)
    p_w = 0 if weights is None else need(weights, "weights", torch.float32,
                                         lead + (m,), dev)
    n_in = 0 if slot_map is None else slot_map.shape[-1]
    p_map = 0 if slot_map is None else need(slot_map, "slot_map", torch.int32,
                                            lead + (n_in,), dev)
    fused = phist is not None
    pairs = fused and side is None
    if pairs:
        _no_pairs_map(slot_map)
    if fused:
        p_ph = need(phist, "phist", torch.float32,
                    lead + (num_slots, k, n_bins, c), dev)
    p_side = 0 if not fused or pairs else need(
        side, "side", torch.int32, lead + (num_slots,), dev)
    out = torch.empty(lead + ((2 if fused else 1) * num_slots, k, n_bins, c),
                      dtype=torch.float32, device=dev)
    modes = _modes(bool(lanes), weights, slot_map, fused, pairs)
    if fake:
        if out.numel():
            _checks.report("histogram", modes)
        return out, ()
    lib = _build.library()
    if out.numel():
        n_ints, n_floats = ctypes.c_longlong(), ctypes.c_longlong()
        _build.check(lib.udt_histogram_workspace(
            m, max(lanes, 1), k, c, num_slots, n_bins, ctypes.byref(n_ints),
            ctypes.byref(n_floats)), "histogram workspace")
        iws = torch.empty(n_ints.value, dtype=torch.int32, device=dev)
        fws = torch.empty(n_floats.value, dtype=torch.float32, device=dev)
        _build.check(lib.udt_histogram(
            p_bins, p_stats, p_slot, p_w or None, p_map or None, n_in,
            p_ph if fused else None, p_side or None, int(pairs),
            out.data_ptr(), iws.data_ptr(), fws.data_ptr() or None, m,
            max(lanes, 1), k, c, num_slots, n_bins, stream), "histogram")
        _checks.report("histogram", modes, lambda: _smem(lib, k, c, n_bins))
    return out, modes if out.numel() else ()


def _smem(lib, k, c, n_bins) -> int:
    """Dynamic shared memory of the launch's tile blocks, as planned."""
    smem = ctypes.c_longlong()
    _build.check(lib.udt_histogram_smem(k, c, n_bins, ctypes.byref(smem)),
                 "histogram shared-memory plan")
    return smem.value


def _modes(stacked, weights, slot_map, fused, pairs) -> tuple:
    """Every mode a launch uses (a fused launch runs the ``slot_map``
    remap too; a pairs launch is fused, and makes its own map); ``plain``
    for a launch with none."""
    modes = tuple(m for m, on in (("stacked", stacked),
                                  ("weights", weights is not None),
                                  ("slot_map", slot_map is not None),
                                  ("fused", fused),
                                  ("pairs", pairs)) if on)
    return modes or ("plain",)


def _count(modes):
    """One launch counts under every mode it uses (``_modes``)."""
    for mode in modes:
        histogram_cuda.launches[mode] += 1


def histogram_cuda(bins, stats, slot, *, num_slots, n_bins, weights=None,
                   slot_map=None, phist=None, side=None):
    """Launch the CUDA histogram kernel (with ``phist``, it writes the
    interleaved pair block itself; without ``side`` too, it picks the
    computed children itself: ``pairs``).  ``histogram_cuda.launches[mode]``
    counts launches by mode (see ``_count``)."""
    out, modes = _launch(bins, stats, slot, 0, num_slots=num_slots,
                         n_bins=n_bins, weights=weights, slot_map=slot_map,
                         phist=phist, side=side)
    _count(modes)
    return out


def histogram_stacked_cuda(bins, stats, slot, *, num_slots, n_bins,
                           weights=None, slot_map=None, phist=None,
                           side=None):
    """The class-stacked mode: ONE launch for ``L`` lanes over the shared
    ``bins [M, K]``, with ``stats [L, M, C]``, ``slot [L, M]`` and the
    optional ``weights [L, M]``, ``slot_map [L, S_in]``, ``phist [L, P, K,
    B, C]``, ``side [L, P]`` (``phist`` without ``side``: ``pairs``, each
    lane's choice its own).  Lane ``l`` of the output equals, bit for
    bit, ``histogram_cuda`` on lane ``l``'s inputs (each lane keeps its own
    int32-or-fixed-point choice and scale).  Counts under ``stacked`` and
    under every other mode it uses."""
    lanes = stats.shape[0] if stats.dim() == 3 else -1
    if lanes < 1:
        raise ValueError(f"stats: expected [L, M, C] with L >= 1, got shape "
                         f"{tuple(stats.shape)}")
    out, modes = _launch(bins, stats, slot, lanes, num_slots=num_slots,
                         n_bins=n_bins, weights=weights, slot_map=slot_map,
                         phist=phist, side=side)
    _count(modes)
    return out


histogram_cuda.launches = dict.fromkeys(MODES, 0)
