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
                                           histogram_plain,
                                           histogram_stacked_cuda,
                                           histogram_stacked_plain)
from repro_torch.kernels.linear_scan import (linear_scan_backward_cuda,
                                             linear_scan_cuda)
from repro_torch.kernels.split_scan import split_scan_cuda, split_scan_plain
from repro_torch.kernels.walk import FIELD_DTYPES, walk_cuda, walk_plain

__all__ = ["histogram", "histogram_stacked", "split_scan", "walk",
           "launch_counts", "reset_launch_counts"]


def _place(device, first, *rest):
    """Device of the call: ``first``'s if it is a tensor, else ``device``."""
    dev = first.device if isinstance(first, torch.Tensor) else resolve_device(device)
    return dev, [None if x is None else torch.as_tensor(x, device=dev)
                 for x in (first, *rest)]


def _histogram(kernel, plain, bins, stats, slot, *, num_slots, n_bins,
               weights, slot_map, phist, side, device):
    dev, (bins, stats, slot, weights, slot_map, phist, side) = _place(
        device, bins, stats, slot, weights, slot_map, phist, side)
    if weights is not None:
        weights = weights.to(torch.float32)
    if slot_map is not None:
        slot_map = slot_map.to(torch.int32)
    if side is not None:
        side = side.to(torch.int32)
    fn = kernel if dev.type == "cuda" else plain
    return fn(bins, stats, slot, num_slots=num_slots, n_bins=n_bins,
              weights=weights, slot_map=slot_map, phist=phist, side=side)


def histogram(bins, stats, slot, *, num_slots, n_bins, weights=None,
              slot_map=None, phist=None, side=None, device=None):
    """H[S,K,B,C] (or the fused [2S,K,B,C] pair block with ``phist`` /
    ``side``, or with ``phist`` alone the pair block whose computed
    children the call picks itself); see ``kernels/histogram.py`` for the
    modes."""
    return _histogram(histogram_cuda, histogram_plain, bins, stats, slot,
                      num_slots=num_slots, n_bins=n_bins, weights=weights,
                      slot_map=slot_map, phist=phist, side=side,
                      device=device)


def histogram_stacked(bins, stats, slot, *, num_slots, n_bins, weights=None,
                      slot_map=None, phist=None, side=None, device=None):
    """The class-stacked histogram: ``L`` lanes (``stats [L, M, C]``,
    ``slot [L, M]``, optional ``weights [L, M]``, ``slot_map [L, S_in]``,
    ``phist [L, P, K, B, C]`` / ``side [L, P]``) over one shared ``bins [M,
    K]`` -> ``[L, S, K, B, C]`` (fused ``[L, 2P, K, B, C]``), one kernel
    launch on a CUDA tensor."""
    return _histogram(histogram_stacked_cuda, histogram_stacked_plain, bins,
                      stats, slot, num_slots=num_slots, n_bins=n_bins,
                      weights=weights, slot_map=slot_map, phist=phist,
                      side=side, device=device)


def split_scan(hist, n_num, n_cat, *, heuristic="info_gain", min_leaf=1,
               device=None):
    """(score [S,K], bin [S,K], op [S,K]): the fused selection scan."""
    dev, (hist, n_num, n_cat) = _place(device, hist, n_num, n_cat)
    fn = split_scan_cuda if dev.type == "cuda" else split_scan_plain
    return fn(hist, n_num.to(torch.int32), n_cat.to(torch.int32),
              heuristic=heuristic, min_leaf=min_leaf)


def walk(fields, bins, n_num, *, num_steps, n_nodes=None,
         max_depth=1 << 30, min_samples_split=0, min_child_weight=0.0):
    """Leaf labels ``[T, M]`` f32 of T trees walked down together:
    ``fields`` holds the stacked ``[T, N]`` WALK_FIELDS tensors, ``bins``
    is ``[M, K]`` int32 and ``n_num`` ``[K]`` or ``[T, K]``, on one device.
    The runtime limits are ``predict_bins``'s; ``n_nodes`` (CUDA only) is
    the count of leading slots that hold every reachable node, so that the
    kernel stages no more (see ``kernels/walk.py``)."""
    fields = {f: fields[f].to(dtype) for f, dtype in FIELD_DTYPES.items()}
    if (len({v.stride() for v in fields.values()}) > 1
            or fields["feat"].stride(-1) != 1):
        # the kernel reads every field's rows at one stride, contiguous
        fields = {f: v.contiguous() for f, v in fields.items()}
    kw = dict(steps=min(num_steps, max(max_depth - 1, 0)),
              min_samples_split=min_samples_split,
              min_child_weight=min_child_weight)
    n_num = n_num.to(torch.int32)
    if bins.device.type != "cuda":
        return walk_plain(fields, bins, n_num, **kw)
    return walk_cuda(fields, bins, n_num, n_nodes=n_nodes, **kw)


def launch_counts() -> dict:
    """Launches of every CUDA kernel since the last reset, by name."""
    out = {("histogram" if mode == "plain" else f"histogram_{mode}"): n
           for mode, n in histogram_cuda.launches.items()}
    out["split_scan"] = split_scan_cuda.launches
    out["linear_scan"] = linear_scan_cuda.launches
    out["linear_scan_backward"] = linear_scan_backward_cuda.launches
    out["walk"] = walk_cuda.launches
    return out


def reset_launch_counts() -> None:
    histogram_cuda.launches = dict.fromkeys(MODES, 0)
    split_scan_cuda.launches = 0
    linear_scan_cuda.launches = 0
    linear_scan_backward_cuda.launches = 0
    walk_cuda.launches = 0
