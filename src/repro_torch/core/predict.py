"""Vectorised prediction (paper Algorithm 7), in torch.

Counterpart of ``repro.core.predict``.  The predict function takes
``max_depth`` / ``min_samples_split`` / ``min_child_weight`` as RUNTIME
arguments: a full-grown tree answers queries *as if* it had been trained
with those hyper-parameters (it returns the current node's label as soon as
the walk hits a leaf, a node with fewer than ``min_split`` examples, a
split whose lighter child carries <= ``min_child_weight``, or the depth
limit).  This is what makes Training-Only-Once Tuning possible.

The walk is plain tensor code (the reference's is plain XLA, no kernel): a
Python loop of gathers over a static number of steps.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core.split import evaluate_predicate
from repro_torch.core.tree import Tree

__all__ = ["predict_bins", "paths", "stack_trees", "WALK_FIELDS"]

# the Tree fields the Algorithm-7 walk reads
WALK_FIELDS = ("feat", "op", "tbin", "label", "count", "left", "right",
               "leaf")

# fill values that make a padding node slot inert under the walk: a leaf
# sentinel (left = -1 stops the descent) with label 0
_PAD_FILLS = dict(feat=-1, op=-1, tbin=-1, label=0.0, count=0, left=-1,
                  right=-1, leaf=False)


def stack_trees(trees) -> dict:
    """Stack per-tree WALK_FIELDS into ``[T, max_nodes]`` tensors; trees
    with fewer node slots than the widest are padded with inert leaf slots
    (``_PAD_FILLS``), which are unreachable from the root."""
    width = max(t.feat.shape[0] for t in trees)

    def pad(a, fill):
        n = a.shape[0]
        if n == width:
            return a
        return torch.cat([a, torch.full((width - n,), fill, dtype=a.dtype,
                                        device=a.device)])

    return {f: torch.stack([pad(getattr(t, f), _PAD_FILLS[f]) for t in trees])
            for f in WALK_FIELDS}


def _descend(ta, bins, n_num, node):
    f = ta["feat"][node].clamp(min=0).long()
    xb = bins.gather(1, f[:, None])[:, 0]
    pos = evaluate_predicate(xb, n_num[f], ta["op"][node], ta["tbin"][node])
    return torch.where(pos, ta["left"][node], ta["right"][node]).long()


def _walk(ta, bins, n_num, dmax, smin, mcw, num_steps):
    node = torch.zeros((bins.shape[0],), dtype=torch.long, device=bins.device)
    for i in range(num_steps):
        can = (~ta["leaf"][node]
               & (ta["left"][node] >= 0)
               & (ta["count"][node] >= smin)
               & (i < dmax - 1))
        # runtime min_child_weight mirrors the builder's stopping rule; the
        # index guards keep the gathers in bounds at leaves (can is False)
        lc = ta["left"][node].clamp(min=0).long()
        rc = ta["right"][node].clamp(min=0).long()
        child_min = torch.minimum(ta["count"][lc], ta["count"][rc])
        can = can & ((mcw <= 0) | (child_min > mcw))
        node = torch.where(can, _descend(ta, bins, n_num, node), node)
    return ta["label"][node]


def _walk_inputs(tree, bins, n_num, device):
    dev = resolve_device(device)
    ta = {f: getattr(tree, f).to(dev) for f in WALK_FIELDS}
    return (ta, torch.as_tensor(bins, dtype=torch.int32, device=dev),
            torch.as_tensor(n_num, dtype=torch.int32, device=dev))


def predict_bins(tree: Tree, bins, n_num, *, max_depth: int = 1 << 30,
                 min_samples_split: int = 0, min_child_weight: float = 0.0,
                 num_steps: int | None = None, device=None) -> torch.Tensor:
    """Predict labels [M] f32 for pre-binned examples on ``device``
    (``None`` means CUDA) under runtime hyper-parameters.

    ``num_steps`` overrides the walk length (any bound >= the tree's depth
    works; extra steps stay at the leaf); the default reads the tree's
    depth."""
    ta, bins, n_num = _walk_inputs(tree, bins, n_num, device)
    steps = num_steps if num_steps is not None else max(1, tree.max_tree_depth)
    return _walk(ta, bins, n_num, max_depth, min_samples_split,
                 float(min_child_weight), max(1, steps))


def paths(tree: Tree, bins, n_num, device=None) -> torch.Tensor:
    """Full root->leaf walk per example: node ids [M, T] int32 with
    stay-at-leaf semantics (columns past the leaf repeat the leaf).
    T = tree depth."""
    ta, bins, n_num = _walk_inputs(tree, bins, n_num, device)
    node = torch.zeros((bins.shape[0],), dtype=torch.long, device=bins.device)
    trail = [node]
    for _ in range(max(1, tree.max_tree_depth) - 1):
        can = (~ta["leaf"][node]) & (ta["left"][node] >= 0)
        node = torch.where(can, _descend(ta, bins, n_num, node), node)
        trail.append(node)
    return torch.stack(trail, dim=1).to(torch.int32)
