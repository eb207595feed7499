"""Plain reference of Training-Only-Once Tuning (PyTorch, no kernels).

A cell ``(max_depth d, min_samples_split s)`` of the grid is the accuracy
on the validation rows of the tree pruned at prediction time: a row walks
from the root and stops at the first node that is a leaf, sits at depth
``d``, or holds fewer than ``s`` training rows; it takes that node's
label.  The paper's protocol sweeps ``d`` over 1 .. the tree's depth and
``s`` over 200 values from 0 to 4 % of the training rows in steps of
0.02 %.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.tree import predicate

__all__ = ["paper_axes", "grid_correct"]


def paper_axes(full_depth: int, n_train: int):
    dmax = np.arange(1, full_depth + 1)
    smin = np.round(np.arange(200) * (0.0002 * n_train)).astype(np.int64)
    return dmax, smin


def grid_correct(tree: dict, val_bins, y_val, n_num, dmax, smin,
                 dtype=torch.int64):
    """``[Nd, Ns]`` count of validation rows each cell predicts right,
    summed in ``dtype``; ``tree`` holds numpy fields of the built tree."""
    dev = val_bins.device
    t = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in tree.items()}
    n_num = torch.as_tensor(n_num, device=dev).long()
    steps = int(np.asarray(tree["depth"]).max())
    node = torch.zeros(val_bins.shape[0], dtype=torch.long, device=dev)
    trail = [node]
    for _ in range(steps - 1):
        inner = ~t["leaf"][node] & (t["left"][node] >= 0)
        f = t["feat"][node].clamp(min=0).long()
        xb = val_bins.gather(1, f[:, None])[:, 0].long()
        go = predicate(xb, n_num[f], t["op"][node].long(), t["tbin"][node].long())
        node = torch.where(inner, torch.where(go, t["left"][node],
                                              t["right"][node]).long(), node)
        trail.append(node)
    path = torch.stack(trail, 1)                                   # [M, T]
    cnt, lab = t["count"][path], t["label"][path]
    y = torch.as_tensor(np.asarray(y_val), device=dev).to(lab.dtype)
    out = torch.zeros((len(dmax), len(smin)), dtype=dtype, device=dev)
    for j, s in enumerate(smin):
        fails = cnt < int(s)
        first = torch.where(fails.any(1), fails.to(torch.int8).argmax(1),
                            torch.full_like(path[:, 0], steps - 1))
        for i, d in enumerate(dmax):
            at = torch.minimum(first, torch.full_like(first, int(d) - 1))
            right = lab.gather(1, at[:, None])[:, 0] == y
            out[i, j] = right.to(dtype).sum(dtype=dtype)
    return out
