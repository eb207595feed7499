"""Kernel A, the node / feature / bin histogram: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``repro.kernels.histogram.histogram_pallas``.  For every row
whose slot (after the optional ``slot_map`` remap, where -1 drops the row)
lies in ``[0, num_slots)``, add ``w[i] * stats[i, :]`` at
``H[slot, k, bins[i, k], :]`` for every feature ``k``.  Four modes, all in
one kernel: plain; ``weights``; ``slot_map``; and fused sibling derivation
(``phist`` / ``side``), which returns the interleaved ``[2P, K, B, C]``
child block with the co-child derived as ``phist - H_small``.

``histogram_cuda`` launches ``csrc/histogram.cu`` (one thread per (row,
feature), atomics into H, plus an epilogue launch in fused mode; the source
says what bounds it).  ``histogram_plain`` is the same function as a masked
``index_add_``: the CPU path and the kernel's yardstick on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import need, stream_of

__all__ = ["histogram_cuda", "histogram_plain", "interleave_pairs",
           "remap_slots", "MODES"]

MODES = ("plain", "weights", "slot_map", "fused")


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
    """Masked ``index_add_`` form of the kernel (all four modes)."""
    m, k = bins.shape
    c = stats.shape[-1]
    if slot_map is not None:
        slot = remap_slots(slot, slot_map)
    if weights is not None:
        stats = stats * weights[:, None].to(torch.float32)
    rows = ((slot >= 0) & (slot < num_slots)).nonzero()[:, 0]
    feat = torch.arange(k, device=bins.device)
    idx = ((slot[rows].long()[:, None] * k + feat) * n_bins
           + bins[rows].long())                                  # [R, K]
    h = torch.zeros((num_slots * k * n_bins, c), dtype=torch.float32,
                    device=bins.device)
    h.index_add_(0, idx.reshape(-1),
                 stats[rows][:, None, :].expand(-1, k, -1).reshape(-1, c))
    h = h.view(num_slots, k, n_bins, c)
    return h if phist is None else interleave_pairs(h, phist, side)


def histogram_cuda(bins, stats, slot, *, num_slots, n_bins, weights=None,
                   slot_map=None, phist=None, side=None):
    """Launch the CUDA histogram kernel (and, with ``phist``, the sibling
    epilogue).  ``histogram_cuda.launches[mode]`` counts launches by mode;
    one launch counts under every mode it uses (a fused launch runs the
    ``slot_map`` remap too), and ``plain`` counts launches with none."""
    dev = bins.device
    stream = stream_of(dev)
    m, k = bins.shape
    c = stats.shape[-1] if stats.dim() == 2 else -1
    p_bins = need(bins, "bins", torch.int32, (m, k), dev)
    p_stats = need(stats, "stats", torch.float32, (m, c), dev)
    p_slot = need(slot, "slot", torch.int32, (m,), dev)
    p_w = 0 if weights is None else need(weights, "weights", torch.float32,
                                         (m,), dev)
    n_in = 0 if slot_map is None else slot_map.shape[0]
    p_map = 0 if slot_map is None else need(slot_map, "slot_map", torch.int32,
                                            (n_in,), dev)
    fused = phist is not None
    if fused:
        p_ph = need(phist, "phist", torch.float32,
                    (num_slots, k, n_bins, c), dev)
        p_side = need(side, "side", torch.int32, (num_slots,), dev)
    lib = _build.library()
    small = torch.zeros((num_slots, k, n_bins, c), dtype=torch.float32,
                        device=dev)
    if m * k and small.numel():
        _build.check(lib.udt_histogram(p_bins, p_stats, p_slot, p_w or None,
                                       p_map or None, n_in, small.data_ptr(),
                                       m, k, c, num_slots, n_bins, stream),
                     "histogram")
        modes = histogram_cuda.launches
        modes["weights"] += weights is not None
        modes["slot_map"] += slot_map is not None
        modes["fused"] += fused
        modes["plain"] += weights is None and slot_map is None and not fused
    if not fused:
        return small
    out = torch.empty((2 * num_slots, k, n_bins, c), dtype=torch.float32,
                      device=dev)
    if out.numel():
        _build.check(lib.udt_sibling_epilogue(small.data_ptr(), p_ph, p_side,
                                              out.data_ptr(), num_slots,
                                              k * n_bins * c, stream),
                     "sibling epilogue")
    return out


histogram_cuda.launches = dict.fromkeys(MODES, 0)
