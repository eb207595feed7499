"""Kernel B, the fused prefix-sum -> heuristic -> argmax split scan: the
CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of ``repro.kernels.split_scan.split_scan_pallas``.
``hist [S, K, B, C] -> (score [S, K] f32, bin [S, K] i32, op [S, K] i32)``:
the best candidate of every (slot, feature) over the three families
``<=`` / ``>`` / ``=``, first maximum in op-major order.  The cross-feature
argmax is left to the caller (``core.split.best_splits_kernel``).

``split_scan_cuda`` launches ``csrc/split_scan.cu`` (one thread per (slot,
feature); the source says what bounds it).  ``split_scan_plain`` is the
``[3, S, K, B, C]`` tensor form: the CPU path and the kernel's yardstick on
the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import heuristics as H
from repro_torch.core.split import candidate_scores
from repro_torch.kernels import _build
from repro_torch.kernels._checks import need, stream_of

__all__ = ["split_scan_cuda", "split_scan_plain"]


def split_scan_plain(hist, n_num, n_cat, *, heuristic="info_gain",
                     min_leaf=1):
    """Tensor form of the scan: every candidate of every (slot, feature)
    materialised as ``[3, S, K, B, C]`` pos/neg blocks, then the first
    maximum over each (slot, feature)'s flat ``[3, B]``, op-major."""
    s, k, b, _ = hist.shape
    score, _, _ = candidate_scores(hist, n_num, n_cat, heuristic=heuristic,
                                   min_leaf=min_leaf)          # [3,S,K,B]
    flat = score.permute(1, 2, 0, 3).reshape(s, k, 3 * b)
    best = torch.argmax(flat, dim=-1)
    best_score = flat.gather(-1, best[..., None])[..., 0]
    return (best_score, (best % b).to(torch.int32),
            (best // b).to(torch.int32))


def split_scan_cuda(hist, n_num, n_cat, *, heuristic="info_gain", min_leaf=1):
    """Launch the CUDA split-scan kernel.  ``split_scan_cuda.launches``
    counts its launches."""
    if heuristic not in H.HEURISTIC_CODES:
        raise ValueError(f"the split-scan kernel scores "
                         f"{list(H.HEURISTIC_CODES)}, not {heuristic!r}")
    dev = hist.device
    stream = stream_of(dev)
    if hist.dim() != 4:
        raise ValueError(f"hist: expected [S, K, B, C], got {tuple(hist.shape)}")
    s, k, b, c = hist.shape
    if not 1 <= c <= 32 or (heuristic == "sse" and c < 2):
        raise ValueError(f"hist: {c} channels; the kernel takes 1..32 "
                         f"(at least 2 for 'sse')")
    p_hist = need(hist, "hist", torch.float32, (s, k, b, c), dev)
    p_num = need(n_num, "n_num", torch.int32, (k,), dev)
    p_cat = need(n_cat, "n_cat", torch.int32, (k,), dev)
    score = torch.empty((s, k), dtype=torch.float32, device=dev)
    tbin = torch.empty((s, k), dtype=torch.int32, device=dev)
    op = torch.empty((s, k), dtype=torch.int32, device=dev)
    if s * k:
        _build.check(_build.library().udt_split_scan(
            p_hist, p_num, p_cat, score.data_ptr(), tbin.data_ptr(),
            op.data_ptr(), s, k, b, c, H.HEURISTIC_CODES[heuristic],
            float(min_leaf), stream), "split scan")
        split_scan_cuda.launches += 1
    return score, tbin, op


split_scan_cuda.launches = 0
