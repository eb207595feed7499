"""Public wrappers around the kernels, with the reference's signatures
(``repro.kernels.ops``).

Dispatch is by device: a CUDA tensor always launches the hand-written CUDA
kernel, a CPU tensor always takes the kernel's plain PyTorch version.  There
is no fallback from one to the other.  Tensor inputs stay where they are;
anything else (numpy arrays) goes to ``device``, whose default ``None``
means CUDA.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.histogram import (MODES, histogram_cuda,
                                           histogram_plain)
from repro_torch.kernels.split_scan import split_scan_cuda, split_scan_plain

__all__ = ["histogram", "split_scan", "launch_counts", "reset_launch_counts"]


def _place(device, first, *rest):
    """Device of the call: ``first``'s if it is a tensor, else ``device``."""
    dev = first.device if isinstance(first, torch.Tensor) else resolve_device(device)
    return dev, [None if x is None else torch.as_tensor(x, device=dev)
                 for x in (first, *rest)]


def histogram(bins, stats, slot, *, num_slots, n_bins, weights=None,
              slot_map=None, phist=None, side=None, device=None):
    """H[S,K,B,C] (or the fused [2S,K,B,C] pair block with ``phist`` /
    ``side``); see ``kernels/histogram.py`` for the modes."""
    dev, (bins, stats, slot, weights, slot_map, phist, side) = _place(
        device, bins, stats, slot, weights, slot_map, phist, side)
    if weights is not None:
        weights = weights.to(torch.float32)
    if slot_map is not None:
        slot_map = slot_map.to(torch.int32)
    if side is not None:
        side = side.to(torch.int32)
    fn = histogram_cuda if dev.type == "cuda" else histogram_plain
    return fn(bins, stats, slot, num_slots=num_slots, n_bins=n_bins,
              weights=weights, slot_map=slot_map, phist=phist, side=side)


def split_scan(hist, n_num, n_cat, *, heuristic="info_gain", min_leaf=1,
               device=None):
    """(score [S,K], bin [S,K], op [S,K]): the fused selection scan."""
    dev, (hist, n_num, n_cat) = _place(device, hist, n_num, n_cat)
    fn = split_scan_cuda if dev.type == "cuda" else split_scan_plain
    return fn(hist, n_num.to(torch.int32), n_cat.to(torch.int32),
              heuristic=heuristic, min_leaf=min_leaf)


def launch_counts() -> dict:
    """Launches of every CUDA kernel since the last reset, by name."""
    out = {("histogram" if mode == "plain" else f"histogram_{mode}"): n
           for mode, n in histogram_cuda.launches.items()}
    out["split_scan"] = split_scan_cuda.launches
    return out


def reset_launch_counts() -> None:
    histogram_cuda.launches = dict.fromkeys(MODES, 0)
    split_scan_cuda.launches = 0
