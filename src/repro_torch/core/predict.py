"""Vectorised prediction (paper Algorithm 7), in torch.

Counterpart of ``repro.core.predict``.  The predict function takes
``max_depth`` / ``min_samples_split`` / ``min_child_weight`` as RUNTIME
arguments: a full-grown tree answers queries *as if* it had been trained
with those hyper-parameters (it returns the current node's label as soon as
the walk hits a leaf, a node with fewer than ``min_split`` examples, a
split whose lighter child carries <= ``min_child_weight``, or the depth
limit).  This is what makes Training-Only-Once Tuning possible.

The walk is one launch of the CUDA walk kernel on the card (``ops.walk``,
``kernels/walk.py``; the reference's walk is plain XLA, no kernel) and its
plain version, a loop of gathers over a static number of steps, on the
CPU.  ``paths`` keeps its own loop of gathers: it returns the whole trail.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core.split import evaluate_predicate
from repro_torch.core.tree import Tree
from repro_torch.kernels import ops
from repro_torch.kernels.walk import FIELD_DTYPES

__all__ = ["predict_bins", "paths", "stack_trees", "walk_class_trees",
           "WALK_FIELDS"]

# the Tree fields the Algorithm-7 walk reads
WALK_FIELDS = tuple(FIELD_DTYPES)

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


def walk_class_trees(class_arrays, bins, n_num, *, num_steps, n_nodes=None,
                     device=None) -> torch.Tensor:
    """Leaf labels ``[C, M]`` f32 of C trees at once: ``class_arrays`` holds
    stacked ``[C, max_nodes]`` WALK_FIELDS arrays (a multiclass round's
    class-trees as ``build_trees_batched`` returns them, or any stacked
    ensemble), walked against the shared ``bins`` with no runtime limits,
    in one ``ops.walk``.  ``n_num`` is ``[K]``, or ``[C, K]`` for trees
    with their own feature masks (a forest).  ``n_nodes``, the largest
    ``Tree.n_nodes`` of the C trees where the caller knows it, bounds the
    slots the card's kernel stages.  ``device`` (``None`` means CUDA)
    applies when the arrays are not tensors."""
    ta = {f: class_arrays[f] for f in WALK_FIELDS}
    dev = (ta["feat"].device if isinstance(ta["feat"], torch.Tensor)
           else resolve_device(device))
    ta = {f: torch.as_tensor(v, device=dev) for f, v in ta.items()}
    bins = torch.as_tensor(bins, dtype=torch.int32, device=dev).contiguous()
    n_num = torch.as_tensor(n_num, dtype=torch.int32, device=dev)
    return ops.walk(ta, bins, n_num, num_steps=max(1, num_steps),
                    n_nodes=n_nodes)


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
    return ops.walk({f: v[None] for f, v in ta.items()}, bins.contiguous(),
                    n_num, num_steps=max(1, steps),
                    n_nodes=tree.n_nodes or None, max_depth=max_depth,
                    min_samples_split=min_samples_split,
                    min_child_weight=float(min_child_weight))[0]


def _paths(ta, bins, n_num, num_steps):
    """Node ids [M, num_steps] int32 of every example's walk, stay-at-leaf."""
    node = torch.zeros((bins.shape[0],), dtype=torch.long, device=bins.device)
    trail = [node]
    for _ in range(num_steps - 1):
        can = (~ta["leaf"][node]) & (ta["left"][node] >= 0)
        node = torch.where(can, _descend(ta, bins, n_num, node), node)
        trail.append(node)
    return torch.stack(trail, dim=1).to(torch.int32)


def paths(tree: Tree, bins, n_num, device=None) -> torch.Tensor:
    """Full root->leaf walk per example: node ids [M, T] int32 with
    stay-at-leaf semantics (columns past the leaf repeat the leaf).
    T = tree depth."""
    ta, bins, n_num = _walk_inputs(tree, bins, n_num, device)
    return _paths(ta, bins, n_num, max(1, tree.max_tree_depth))
