"""Ultrafast Decision Tree (paper Algorithm 5), level-synchronous, in torch.

Counterpart of ``repro.core.tree``.  The tree grows **breadth-first, one
level per step**; every level performs

  1. ONE histogram pass (Superfast statistics collection, O(M*K) scatter
     work), chunked over node slots so the [S, K, B, C] working set stays
     bounded.  With sibling subtraction (the default) the pass touches only
     the examples of the SMALLER child of each split pair; the co-child's
     histogram is derived from the cached parent level as H_parent - H_small,
  2. prefix-sum split selection for every active node at once (O(S*K*B*C)),
  3. ONE routing pass updating each example's node assignment (O(M)).

Node ids are allocated level-contiguously, so "which slot does example i
update" is just ``assign[i] - chunk_start``.

Differences from the reference that are idiom, not semantics:

  * the tree arrays are updated in place.  They carry one extra trailing
    "drop" slot (index ``max_nodes``) that takes every write the reference
    drops with ``.at[ids].set(mode="drop")``; the public ``Tree`` never
    shows it, and ``level_callback`` receives clones.
  * the loop (``_grow``) is plain Python around eager torch ops, one loop
    for one tree and for C trees: its cursors are ``[L]`` host vectors
    (one tree is ``L = 1``) and the host reads the children allocated once
    per chunk.
  * the multiclass build (``build_trees_batched``) writes the reference's
    ``vmap`` over a class axis out: ``[C]`` cursors, ``[C, max_nodes + 1]``
    tree arrays, ``assign [C, M]``, and ONE class-stacked histogram launch
    and one split-scan launch per level chunk for every class.
  * the sharded build (``core.distributed``) runs these same steps in one
    process per rank with ``comm`` (``core.collectives.Collectives``),
    ``data_axes``, ``model_axis`` and ``slot_scatter``: the reference's
    ``shard_map`` body with ``torch.distributed`` collectives.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch._device import resolve_device
from repro_torch.core.binning import BinnedTable
from repro_torch.core.histogram import (BACKENDS, class_stats, moment_stats,
                                        node_histogram,
                                        node_histogram_sibling_fused,
                                        node_histogram_sibling_fused_stacked,
                                        node_histogram_smaller_child,
                                        node_histogram_smaller_child_stacked,
                                        node_histogram_stacked,
                                        smaller_child_mask)
from repro_torch.core.split import (NEG_INF, SplitDecision, best_splits,
                                    best_splits_kernel, evaluate_predicate)
from repro_torch.kernels.histogram import interleave_pairs

__all__ = ["TreeConfig", "Tree", "BuildState", "build_tree",
           "build_trees_batched", "tree_from_numpy", "TREE_FIELDS"]

SELECT_BACKENDS = ("torch", "kernel")


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    max_depth: int = 64               # root has depth 1 (paper convention)
    max_nodes: int = 0                # 0 -> auto (2*M/min_split bounded)
    min_samples_split: int = 2
    min_samples_leaf: int = 1
    heuristic: str = "info_gain"
    task: str = "classification"      # | "regression" (paper label-split)
                                      # | "regression_variance" (beyond-paper)
    n_label_bins: int = 256           # label binning for regression
    hist_backend: str = "segment"     # "segment" | "onehot" | "kernel"
    select_backend: str = "torch"     # "torch" | "kernel" (fused split-scan)
    hist_budget_bytes: int = 1 << 28  # bounds the [S,K,B,C] chunk
    chunk_slots: int = 0              # 0 -> auto from hist_budget_bytes
    # Sibling histogram subtraction: cache the previous level's H[S,K,B,C],
    # scatter only the smaller child of each split pair and derive the
    # co-child as H_parent - H_small.  Bit-exact for classification (integer
    # counts in f32 below 2**24 examples); float moment channels agree to
    # accumulation-order tolerance.  The label-split "regression" task
    # recomputes its per-level pseudo-class statistics, so subtraction does
    # not apply there.
    sibling_subtraction: bool = True
    sub_cache_bytes: int = 1 << 28    # skip caching levels wider than this
    # A post-selection STOPPING rule, not a candidate mask: the node keeps
    # its unconstrained best split but becomes a leaf when that split's
    # lighter child carries <= min_child_weight (rounded) weight.  0.0
    # disables it; select_backend="torch" only (the kernel drops child
    # stats).
    min_child_weight: float = 0.0


TREE_FIELDS = ("feat", "op", "tbin", "score", "label", "count", "depth",
               "left", "right", "leaf", "parent")


class Tree(NamedTuple):
    """Flat tree arrays (max_nodes slots; n_nodes valid)."""
    feat: torch.Tensor      # i32, -1 for leaves
    op: torch.Tensor        # i32 {OP_LE, OP_GT, OP_EQ}, -1 for leaves
    tbin: torch.Tensor      # i32 threshold / category bin
    score: torch.Tensor     # f32 split heuristic
    label: torch.Tensor     # f32 (class id for cls; mean target for regression)
    count: torch.Tensor     # i32 examples reaching the node
    depth: torch.Tensor     # i32, root = 1
    left: torch.Tensor      # i32 child id or -1
    right: torch.Tensor     # i32 child id or -1
    leaf: torch.Tensor      # bool
    parent: torch.Tensor    # i32 parent id, -1 for the root
    n_nodes: int

    @property
    def max_tree_depth(self) -> int:
        d = self.depth[: self.n_nodes]
        return int(tracing.read_scalar(d.max())) if d.numel() else 0


class BuildState(NamedTuple):
    """Per-level build state, handed to ``level_callback`` after each level.

    ``phist`` / ``phist_base`` carry the completed level's full histogram
    (``[level_width, K, B, C]``, base node id ``phist_base``) when it was
    cached for sibling subtraction.  ``build_tree(resume=...)`` re-enters
    the build from one (``checkpoint.tree_ckpt``).  A one-tree build's
    cursors and ``phist_base`` are ints; the batched build's states carry
    a leading class axis, ``[C]`` numpy cursors and, with a cache, a
    ``[C]`` ``phist_base``."""
    arrays: dict
    assign: torch.Tensor
    level_start: int
    level_end: int
    next_free: int
    depth: int
    phist: torch.Tensor | None = None
    phist_base: int = -1


def tree_from_numpy(fields: dict, n_nodes: int) -> Tree:
    """A ``Tree`` from numpy arrays, e.g. the fields of a reference
    ``repro.core.Tree``: the dtypes are kept (int32 / float32 / bool) and
    the tensors stay on the CPU; ``predict_bins`` / ``paths`` move them to
    their device."""
    return Tree(n_nodes=int(n_nodes),
                **{f: torch.from_numpy(np.array(fields[f]))
                   for f in TREE_FIELDS})


def _auto_chunk_slots(k: int, b: int, c: int, budget: int) -> int:
    s = max(1, budget // max(1, k * b * c * 4))
    return int(min(4096, s))


def _init_arrays(max_nodes: int, device=None):
    def i32(fill):
        return torch.full((max_nodes,), fill, dtype=torch.int32, device=device)
    return dict(
        feat=i32(-1), op=i32(-1), tbin=i32(-1),
        score=torch.full((max_nodes,), NEG_INF, dtype=torch.float32,
                         device=device),
        label=torch.zeros((max_nodes,), dtype=torch.float32, device=device),
        count=i32(0), depth=i32(0), left=i32(-1), right=i32(-1),
        leaf=torch.zeros((max_nodes,), dtype=torch.bool, device=device),
        parent=i32(-1),
    )


# ---------------------------------------------------------------------------
# regression label split (paper Algorithm 6): per-node best binary partition
# of the (binned) labels by SSE; turns regression into 2-class selection.
# ---------------------------------------------------------------------------

def _label_split_thresholds(lhist):
    """lhist: [S, Bl, 3] (count, sum_y, sum_y2) per label bin.

    Returns (tstar [S] best label-bin threshold, mean [S], count [S],
    sse [S] total node SSE)."""
    cnt = torch.cumsum(lhist[..., 0], dim=1)         # [S,Bl]
    sy = torch.cumsum(lhist[..., 1], dim=1)
    tot_c = cnt[:, -1:]
    tot_s = sy[:, -1:]
    rc = tot_c - cnt
    rs = tot_s - sy
    score = (sy * sy / torch.where(cnt > 0, cnt, 1.0)
             + rs * rs / torch.where(rc > 0, rc, 1.0))
    score = torch.where((cnt > 0) & (rc > 0), score, NEG_INF)
    tstar = torch.argmax(score, dim=1).to(torch.int32)      # first max
    tot_c0 = torch.where(tot_c[:, 0] > 0, tot_c[:, 0], 1.0)
    mean = tot_s[:, 0] / tot_c0
    sum_y2 = torch.cumsum(lhist[..., 2], dim=1)[:, -1]
    sse = sum_y2 - tot_s[:, 0] * tot_s[:, 0] / tot_c0
    return tstar, mean, tot_c[:, 0], sse


# ---------------------------------------------------------------------------
# one chunk of one level: histogram -> Superfast Selection -> node updates
# ---------------------------------------------------------------------------
#
# The single-tree step and the multiclass step share their pieces; each
# piece takes one tree's tensors ([M] rows, [S] slots, [max_nodes + 1]
# arrays) or C trees' with a leading class axis.

def _chunk_slots(assign, chunk_start, chunk_n, num_slots, max_nodes):
    """(slot of every row, -1 outside the chunk; in-chunk slot mask; node id
    of every slot, the drop slot ``max_nodes`` outside the chunk).  The
    cursors are ints, or [C, 1] tensors for C trees."""
    slot_of_node = assign - chunk_start
    slot = torch.where((slot_of_node >= 0) & (slot_of_node < chunk_n),
                       slot_of_node, -1).to(torch.int32)
    slot_ids = torch.arange(num_slots, dtype=torch.int32, device=assign.device)
    in_chunk = slot_ids < chunk_n
    # index max_nodes is the drop slot: writes the reference drops land there
    node_ids = torch.where(in_chunk, chunk_start + slot_ids, max_nodes)
    return slot, in_chunk, node_ids


def _moment_node_stats(hist):
    """(label, count, pure) of every slot of a (1, y, y^2) moment histogram
    [N, K, B, 3]: the weighted mean, the rounded weighted count, and
    whether the node's weighted SSE is zero (to rounding)."""
    tot = hist[:, 0].sum(dim=1)                                      # [N,3]
    count_f = tot[:, 0]
    safe = torch.where(count_f > 0, count_f, 1.0)
    pure = ((tot[:, 2] - tot[:, 1] ** 2 / safe)
            <= 1e-10 * torch.clamp(count_f, min=1.0))
    return tot[:, 1] / safe, torch.round(count_f).to(torch.int32), pure


def _child_min_count(dec, moment_task):
    """Rounded weighted count of the winning split's lighter child."""
    cp = dec.pos_stats[:, 0] if moment_task else dec.pos_stats.sum(-1)
    cn = dec.neg_stats[:, 0] if moment_task else dec.neg_stats.sum(-1)
    return torch.minimum(torch.round(cp), torch.round(cn))


def _write_nodes(arrays, dec, label, count, pure, child_min, in_chunk,
                 node_ids, next_free, depth, *, min_samples_split, max_depth,
                 max_nodes, min_child_weight):
    """The end of a level chunk, in place: leaf decisions, sibling-pair
    child allocation from ``next_free`` (an int, or [C, 1] for C trees;
    a split past the node budget becomes a leaf), and the node writes.
    Per-slot inputs come flat ([S] or [C * S]).  Returns the children
    allocated, a 0-d or [C] tensor."""
    shape = in_chunk.shape

    def per_slot(x):
        return x.view(shape)

    no_split = per_slot(dec.score) <= NEG_INF / 2
    is_leaf = in_chunk & (per_slot(pure) | no_split
                          | (per_slot(count) < min_samples_split)
                          | (depth >= max_depth))
    if min_child_weight:
        # child_min is garbage where no_split holds -- already a leaf there
        is_leaf = is_leaf | (in_chunk
                             & (per_slot(child_min) <= min_child_weight))
    wants_split = in_chunk & ~is_leaf
    offs = torch.cumsum(wants_split.to(torch.int32), -1,
                        dtype=torch.int32) - 1
    left = next_free + 2 * offs
    right = left + 1
    fits = right < max_nodes
    is_leaf = is_leaf | (wants_split & ~fits)
    wants_split = wants_split & fits
    n_children = 2 * wants_split.sum(dim=-1)
    left = torch.where(wants_split, left, -1)
    right = torch.where(wants_split, right, -1)
    # tree c's arrays start at c * (max_nodes + 1) of the flattened storage
    tree = (torch.arange(shape[0], device=in_chunk.device)[:, None]
            * (max_nodes + 1) if len(shape) == 2 else 0)

    def upd(name, vals, ids=node_ids):
        arrays[name].view(-1)[(tree + ids.long()).reshape(-1)] = (
            vals.reshape(-1).to(arrays[name].dtype))

    # child -> parent back-pointers: next level's sibling subtraction gathers
    # each pair's parent histogram row through these.
    for child in (left, right):
        upd("parent", node_ids, ids=torch.where(wants_split, child, max_nodes))
    upd("feat", torch.where(wants_split, per_slot(dec.feat), -1))
    upd("op", torch.where(wants_split, per_slot(dec.op), -1))
    upd("tbin", torch.where(wants_split, per_slot(dec.bin), -1))
    upd("score", torch.where(wants_split, per_slot(dec.score), NEG_INF))
    upd("label", per_slot(label))
    upd("count", per_slot(count))
    upd("depth", torch.full(shape, depth, dtype=torch.int32,
                            device=in_chunk.device))
    upd("left", left)
    upd("right", right)
    upd("leaf", is_leaf)
    return n_children


# The sharded pieces: with ``comm`` (``core.collectives.Collectives``) the
# same steps run as one rank of the reference's ``shard_map`` body.  Rows
# are sharded over ``data_axes`` (the histograms are reduced over them),
# features over ``model_axis`` (the selection and the routing predicate
# are merged over it); with neither, every helper is the identity.

def _reduce_data(x, comm, data_axes, scatter, dim=0):
    """Data-parallel histogram reduction: with ``scatter`` a tiled
    reduce-scatter along the slot axis ``dim`` (this rank keeps its block
    of slots), else a psum."""
    if not data_axes:
        return x
    if scatter:
        return comm.psum_scatter(x, data_axes, "hist", dim)
    return comm.psum(x, data_axes, "hist")


def _counts_psum(comm, data_axes):
    """The reduce of the smaller-child choice's routed counts: a psum over
    the data axes (None without them)."""
    if not data_axes:
        return None
    return lambda cnt: comm.psum(cnt, data_axes, "counts")


def _my_block(x, comm, data_axes, per):
    """This rank's tiled block of ``per`` entries along the last axis of
    ``x`` (``psum_scatter``'s order)."""
    return x.narrow(-1, comm.data_index(data_axes) * per, per)


def _derive_siblings(h_small, phist_pairs, small_is_left):
    """The co-child of each packed smaller child as ``H_parent - H_small``,
    interleaved into full slots; lanes of a leading class axis fold into
    the pair axis."""
    lead, tail = h_small.shape[:-4], h_small.shape[-3:]
    full = interleave_pairs(h_small.reshape(-1, *tail),
                            phist_pairs.reshape(-1, *tail),
                            small_is_left.reshape(-1))
    return full.view(*lead, -1, *tail)


def _pick_global(dec, mc, node, comm, model_axis, k_local, n_bins):
    """Feature-parallel selection: every model shard picked its best LOCAL
    split; one all-gather of the ``[9, N]`` candidate tuples (score, global
    feature, bin, op, global op-major flat index, the winner's child-min
    count, the node's count / label / purity) gives the global winner: the
    maximum score, then the lowest global flat index.  With the flat
    op-major ``best_splits`` this is the local build's own pick; with the
    split-scan kernel's first-feature rule it is the reference's
    cross-shard rule, which can differ on a tie.

    ``node`` = (count, label, pure) comes back from model shard 0: each
    shard sums its first feature's bins, which is global feature 0 (the
    local build's source) only there, and float sums over other features'
    bins round differently; so every rank writes the same node.  ``node``
    None: the caller's node stats are the same on every shard already."""
    k_tot = k_local * comm.axis_size(model_axis)
    feat_g = dec.feat + comm.axis_index(model_axis) * k_local
    flat_idx = (dec.op * k_tot + feat_g) * n_bins + dec.bin
    cand = torch.stack([dec.score, feat_g.to(torch.float32),
                        dec.bin.to(torch.float32), dec.op.to(torch.float32),
                        flat_idx.to(torch.float32), mc]
                       + ([] if node is None else
                          [node[0].view(torch.float32), node[1],
                           node[2].to(torch.float32)]))               # [9, N]
    allc = comm.all_gather(cand[None], (model_axis,), "select")      # [P,9,N]
    best = allc[:, 0].max(dim=0).values
    key = torch.where(allc[:, 0] >= best[None], allc[:, 4], 3e38)
    win = torch.argmin(key, dim=0)                                   # first min

    def pick(j):
        return allc[:, j].gather(0, win[None])[0]

    first = allc[0]
    return (SplitDecision(pick(0), pick(1).to(torch.int32),
                          pick(2).to(torch.int32), pick(3).to(torch.int32),
                          None, None), pick(5),
            None if node is None else
            (first[6].contiguous().view(torch.int32), first[7],
             first[8] != 0))


def _regather(xs, comm, data_axes, scatter, lanes=0):
    """Per-slot results of a slot-scattered chunk back to the full slot
    axis (one all-gather over the data axes for all of them); ``lanes``
    trees' slots come flat as ``[lanes * S_local]``."""
    if not (scatter and data_axes):
        return xs
    if lanes:
        xs = [x.view(lanes, -1) for x in xs]
    out = comm.all_gather_many(xs, data_axes, "regather", dim=1 if lanes else 0)
    return [x.reshape(-1) for x in out] if lanes else out


def _regather_nodes(count, label, pure, dec, mc, comm, data_axes, scatter,
                    lanes=0):
    count, label, pure, score, feat, tbin, op, mc = _regather(
        [count, label, pure, dec.score, dec.feat, dec.bin, dec.op, mc],
        comm, data_axes, scatter, lanes)
    return count, label, pure, SplitDecision(score, feat, tbin, op, None,
                                             None), mc


def _chunk_step(bins, stats, lbins, y, assign, arrays, phist_pairs, n_num,
                n_cat, chunk_start, chunk_n, next_free, depth, weights=None, *,
                num_slots, n_bins, heuristic, task, min_samples_split,
                min_samples_leaf, max_depth, max_nodes, hist_backend,
                select_backend, n_label_bins, use_sub=False, want_hist=False,
                weighted=False, min_child_weight=0.0, comm=None, data_axes=(),
                model_axis=None, slot_scatter=False):
    """Process node slots [chunk_start, chunk_start+chunk_n) in place.

    ``stats`` is read by "classification" alone, ``lbins`` by label-split
    "regression" alone and ``y`` by the two regression tasks; an operand
    the task does not read may be None.

    Returns (arrays, n_children, hist): ``n_children`` is a 0-d tensor,
    ``hist`` the chunk's full histogram when ``want_hist`` (for the next
    level's parent cache), else None.

    ``use_sub``: ``phist_pairs`` holds the parent histogram of sibling pair
    ``j = slot // 2`` ([num_slots//2, K, B, C], from ``_parent_rows``);
    statistics are scattered only for the smaller child of each pair and
    the co-child is ``H_parent - H_small`` (in the kernel's epilogue on the
    ``kernel`` backend).

    ``weighted`` + ``weights`` ([M] f32): histograms accumulate
    ``w[i] * stats[i]``, so counts, labels and purity are weighted; weighted
    counts are rounded to the nearest int before the int32 cast.  The
    smaller-child choice stays on raw routed rows.

    Sharded (``comm`` given, one rank of ``core.distributed``): ``bins`` /
    the row tensors are this rank's block of rows and features.  The
    histogram is reduced over ``data_axes``; with ``slot_scatter`` it is
    reduce-scattered over slots and ``hist`` / ``phist_pairs`` are this
    rank's block of them (composed with subtraction: the packed pair axis
    is scattered and the co-children are derived from this rank's pairs).
    With data axes the smaller child (from counts psum'd over the data
    axes) and the subtraction are separate steps; only ``data_axes=()``
    keeps the kernel's fused epilogue, whose launch picks the smaller
    children itself.
    """
    s = num_slots
    moment_task = task in ("regression", "regression_variance")
    scatter = bool(slot_scatter and data_axes)

    def reduce(x):
        return _reduce_data(x, comm, data_axes, scatter)

    def select(hist, node, *, heuristic, min_leaf):
        """(decision, child-min count, node stats (count, label, pure))."""
        fn = best_splits_kernel if select_backend == "kernel" else best_splits
        dec = fn(hist, n_num, n_cat, heuristic=heuristic, min_leaf=min_leaf)
        mc = _child_min_count(dec, moment_task)
        if model_axis is None:
            return dec, mc, node
        return _pick_global(dec, mc, node, comm, model_axis, hist.shape[1],
                            n_bins)

    slot, in_chunk, node_ids = _chunk_slots(assign, chunk_start, chunk_n, s,
                                            max_nodes)
    w = weights if weighted else None

    def build_hist(stats_rows):
        """One level-chunk histogram: full scatter, or smaller-child scatter
        plus sibling subtraction when the parent cache is available."""
        if not use_sub:
            return reduce(node_histogram(bins, stats_rows, slot, num_slots=s,
                                         n_bins=n_bins, backend=hist_backend,
                                         weights=w))
        # slots past chunk_n gather garbage parent rows; every downstream
        # write of those slots goes to the drop slot.  One device: the
        # histogram call picks the smaller children (in the kernel's launch
        # on the kernel backend); sharded rows need global counts first.
        if not data_axes:
            return node_histogram_sibling_fused(
                bins, stats_rows, slot, None, phist_pairs, num_slots=s,
                n_bins=n_bins, backend=hist_backend, weights=w)
        compute = smaller_child_mask(slot, s, _counts_psum(comm, data_axes))
        h_small = reduce(node_histogram_smaller_child(
            bins, stats_rows, slot, compute, num_slots=s, n_bins=n_bins,
            backend=hist_backend, weights=w))
        side = compute[0::2]
        if scatter:
            side = _my_block(side, comm, data_axes, h_small.shape[0])
        return _derive_siblings(h_small, phist_pairs, side)

    if task == "regression":
        # Algorithm 6: per-node label split -> per-example pseudo class.
        lhist = reduce(node_histogram(lbins[:, None], moment_stats(y), slot,
                                      num_slots=s, n_bins=n_label_bins,
                                      backend=hist_backend)[:, 0])   # [S,Bl,3]
        tstar, label, count_f, sse = _regather(
            list(_label_split_thresholds(lhist)), comm, data_axes, scatter)
        pseudo = lbins <= tstar[slot.clamp(0, s - 1).long()]
        stats = class_stats(pseudo, 2)
        count = torch.round(count_f).to(torch.int32)
        pure = sse <= 1e-10 * torch.clamp(count_f, min=1.0)
        hist = build_hist(stats)
        # count / label / pure come from the label histogram, the same on
        # every model shard
        dec, mc, _ = select(hist, None, heuristic=heuristic,
                            min_leaf=min_samples_leaf)
        score, feat, tbin, op, mc = _regather(
            [dec.score, dec.feat, dec.bin, dec.op, mc], comm, data_axes,
            scatter)
        dec = SplitDecision(score, feat, tbin, op, None, None)
    elif task == "regression_variance":
        hist = build_hist(moment_stats(y))
        label, count, pure = _moment_node_stats(hist)
        dec, mc, (count, label, pure) = select(
            hist, (count, label, pure), heuristic="sse",
            min_leaf=min_samples_leaf)
        count, label, pure, dec, mc = _regather_nodes(
            count, label, pure, dec, mc, comm, data_axes, scatter)
    else:
        hist = build_hist(stats)
        tot = hist[:, 0].sum(dim=1)                                  # [S,C]
        count = torch.round(tot.sum(-1)).to(torch.int32)
        label = torch.argmax(tot, dim=-1).to(torch.float32)         # first max
        pure = tot.max(-1).values == tot.sum(-1)
        dec, mc, (count, label, pure) = select(
            hist, (count, label, pure), heuristic=heuristic,
            min_leaf=min_samples_leaf)
        count, label, pure, dec, mc = _regather_nodes(
            count, label, pure, dec, mc, comm, data_axes, scatter)

    n_children = _write_nodes(
        arrays, dec, label, count, pure, mc, in_chunk, node_ids, next_free,
        depth, min_samples_split=min_samples_split, max_depth=max_depth,
        max_nodes=max_nodes, min_child_weight=min_child_weight)
    return arrays, n_children, (hist if want_hist else None)


def _chunk_step_classes(bins, z, assign, arrays, phist_pairs, n_num, n_cat,
                        cs, cn, next_free, depth, weights=None, *, num_slots,
                        n_bins, min_samples_split, min_samples_leaf,
                        max_depth, max_nodes, hist_backend, select_backend,
                        use_sub=False, want_hist=False, min_child_weight=0.0,
                        comm=None, data_axes=(), model_axis=None,
                        slot_scatter=False):
    """The multiclass level-chunk step: ``_chunk_step``'s
    ``regression_variance`` arithmetic with a class axis written out, in
    place.  Per class (leading ``[C]``): the targets ``z``, ``assign``, the
    tree arrays ``[C, max_nodes + 1]``, ``phist_pairs``, ``weights`` and
    the ``cs`` / ``cn`` / ``next_free`` cursor tensors; shared: the bins,
    the feature vectors and ``depth`` (the classes run the same level in
    lockstep).  A class whose frontier is narrower rides along with
    ``cn = 0``: every slot is out of chunk, every write goes to the drop
    slot.  The histogram is ONE class-stacked call and the selection one
    call over the ``[C * S]`` slot block, so each class's results are
    those of ``_chunk_step`` on that class.  Returns (arrays, n_children
    [C], hist [C, S, K, B, 3] when ``want_hist``).  The sharded arguments
    are ``_chunk_step``'s, with the slot axis at dim 1."""
    s = num_slots
    n_cls = z.shape[0]
    scatter = bool(slot_scatter and data_axes)
    slot, in_chunk, node_ids = _chunk_slots(assign, cs[:, None], cn[:, None],
                                            s, max_nodes)
    stats = moment_stats(z)                                        # [C, M, 3]
    if not use_sub:
        hist = _reduce_data(node_histogram_stacked(
            bins, stats, slot, num_slots=s, n_bins=n_bins,
            backend=hist_backend, weights=weights), comm, data_axes, scatter,
            dim=1)
    elif not data_axes:
        hist = node_histogram_sibling_fused_stacked(
            bins, stats, slot, None, phist_pairs, num_slots=s, n_bins=n_bins,
            backend=hist_backend, weights=weights)
    else:
        compute = smaller_child_mask(slot, s, _counts_psum(comm, data_axes))
        h_small = _reduce_data(node_histogram_smaller_child_stacked(
            bins, stats, slot, compute, num_slots=s, n_bins=n_bins,
            backend=hist_backend, weights=weights), comm, data_axes, scatter,
            dim=1)
        side = compute[:, 0::2]
        if scatter:
            side = _my_block(side, comm, data_axes, h_small.shape[1])
        hist = _derive_siblings(h_small, phist_pairs, side)
    flat = hist.reshape(n_cls * hist.shape[1], *hist.shape[2:])     # [C*S,..]
    label, count, pure = _moment_node_stats(flat)
    fn = best_splits_kernel if select_backend == "kernel" else best_splits
    dec = fn(flat, n_num, n_cat, heuristic="sse", min_leaf=min_samples_leaf)
    mc = _child_min_count(dec, True)
    if model_axis is not None:
        dec, mc, (count, label, pure) = _pick_global(
            dec, mc, (count, label, pure), comm, model_axis, flat.shape[1],
            n_bins)
    count, label, pure, dec, mc = _regather_nodes(
        count, label, pure, dec, mc, comm, data_axes, scatter, lanes=n_cls)
    n_children = _write_nodes(
        arrays, dec, label, count, pure, mc, in_chunk, node_ids,
        next_free[:, None], depth, min_samples_split=min_samples_split,
        max_depth=max_depth, max_nodes=max_nodes,
        min_child_weight=min_child_weight)
    return arrays, n_children, (hist if want_hist else None)


def _route_step(bins, assign, arrays, n_num, level_start, level_end, *,
                comm=None, model_axis=None):
    """One routing pass: every row of the level moves to the child its
    node's split sends it to.  One tree (``assign [M]``, ``[N]`` arrays,
    int cursors) or C trees over the shared bins (``assign [C, M]``,
    ``[C, N]`` arrays, ``[C, 1]`` cursor tensors); rows with ``assign =
    -1`` stay inert.

    Feature-parallel (``model_axis``, ``bins`` / ``n_num`` this rank's
    feature block): only the shard that owns a row's split feature
    evaluates the predicate, and one int32 bit per row is psum'd over the
    model axis."""
    node = assign.clamp(min=0).long()

    def at(name):
        return arrays[name].gather(-1, node)

    left = at("left")
    active = (assign >= level_start) & (assign < level_end) & (left >= 0)
    pos = _node_predicate(bins, at("feat"), at("op"), at("tbin"), n_num,
                          comm, model_axis, "route")
    return torch.where(active, torch.where(pos, left, at("right")), assign)


def _node_predicate(bins, feat, op, tbin, n_num, comm=None, model_axis=None,
                    tag="route"):
    """Whether each row goes left at its node (``feat`` / ``op`` / ``tbin``
    gathered per row, ``[M]`` or ``[C, M]``).  Feature-parallel
    (``model_axis``, ``bins`` / ``n_num`` this rank's feature block): only
    the shard that owns a row's split feature evaluates the predicate, and
    one int32 bit per row is psum'd over the model axis under ``tag``."""
    f = feat.clamp(min=0).long()
    if model_axis is not None:
        k_local = bins.shape[1]
        mine = (f // k_local) == comm.axis_index(model_axis)
        f = torch.where(mine, f % k_local, 0)
    xb = bins.t().gather(0, f.view(-1, f.shape[-1])).view_as(f)  # bins[i, f]
    pos = evaluate_predicate(xb, n_num[f], op, tbin)
    if model_axis is not None:
        pos = comm.psum((pos & mine).to(torch.int32), (model_axis,), tag) > 0
    return pos


# ---------------------------------------------------------------------------
# host-driven level loop (paper Algorithm 5's queue, one level per tick)
# ---------------------------------------------------------------------------

def _label_bins(y, n_label_bins: int):
    """Label-split regression's label bins, made once on the host (the
    paper pre-sorts the labels once) for Alg. 6: ``(bins int32 [M],
    number of bins)``."""
    yy = np.asarray(y, dtype=np.float64)
    uniq = np.unique(yy)
    if uniq.size > n_label_bins:
        edges = np.unique(np.quantile(
            yy, np.linspace(0, 1, n_label_bins), method="nearest"))
    else:
        edges = uniq
    lb = np.minimum(np.searchsorted(edges, yy, side="left"), len(edges) - 1)
    return lb.astype(np.int32), int(len(edges))


def _class_count(y: np.ndarray, n_classes: int | None) -> int:
    """The class count of int labels ``y``, which must lie in [0, C)."""
    c = int(n_classes if n_classes is not None else int(y.max()) + 1)
    if y.size and (y.min() < 0 or y.max() >= c):
        raise ValueError(f"class labels must lie in [0, {c}); got "
                         f"{y.min()} to {y.max()}")
    return c


def _operands(y, config: TreeConfig, n_classes: int | None, put):
    """A one-tree build's row operands on its device: (stats, lbins, y, C,
    n_label_bins).  Only what the task's chunk step reads is made, and only
    what the host alone holds goes through ``put(x, dtype)`` (the upload of
    ``build_tree``, the staging of this rank's rows in the sharded build):
    the one-hot statistics are made on the device from the int32 labels,
    and an operand the task never reads is None ("regression_variance"
    reads ``y``, "classification" ``stats``, label-split "regression"
    ``lbins`` and ``y``)."""
    if config.task == "regression_variance":
        return None, None, put(y, torch.float32), 3, 1
    if config.task == "classification":
        y = np.asarray(y)
        c = _class_count(y, n_classes)
        return class_stats(put(y, torch.int32), c), None, None, c, 1
    lbins, n_label_bins = _label_bins(y, config.n_label_bins)
    return (None, put(lbins, torch.int32), put(y, torch.float32), 2,
            n_label_bins)


def _subtract_eligible(config: TreeConfig, m: int,
                       weighted: bool = False) -> bool:
    """The sibling-subtraction gate.  The label-split "regression" task
    recomputes its pseudo-class statistics every level, so the parent cache
    is invalid; past 2**24 examples f32 integer-count accumulation can
    round.  Weighted classification would lose its bit-exactness contract,
    so subtraction is off there; weighted ``regression_variance`` keeps it
    under its float-tolerance contract."""
    if weighted and config.task != "regression_variance":
        return False
    return (config.sibling_subtraction and config.task != "regression"
            and m < 1 << 24)


def _pair_parents(parent, base, cs, s):
    """Each sibling pair's parent id less the cached level's base id, for
    the level chunk of ``s`` slots at ``cs``: ``[s/2]`` of one tree
    (``parent [max_nodes]``) or ``[C, s/2]`` of C (``parent [C,
    max_nodes]``).  ``cs`` and ``base`` are ``_grow``'s ``[L]`` host
    vectors: one tree's are read as ints, C trees' go up as one ``[2, C]``
    int64.  Ids past the array read -1, as the reference's take/clip."""
    dev, n = parent.device, parent.shape[-1]
    if parent.dim() == 1:
        cs, base = int(cs[0]), int(base[0])
    else:
        cs, base = tracing.to_device(np.stack([cs, base]), torch.int64,
                                     dev)[..., None]
    ids = torch.arange(0, s, 2, device=dev) + cs
    pid = torch.where(ids < n, parent.gather(-1, ids.clamp(max=n - 1)), -1)
    return pid.long() - base


def _parent_rows(parent, cache, cs, s, prev=None):
    """Gather each sibling pair's parent histogram row for one level chunk:
    ``[s/2, K, B, C']`` of one tree, ``[C, s/2, K, B, C']`` of C.

    ``cache`` is (base node ids, H) of the previous level, H its
    ``[W, K, B, C']`` histogram (``[C, W, K, B, C']`` of C trees);
    ``parent`` the parent ids.  Every row index is clamped, so pairs past
    the chunk's valid region gather garbage rows that every consumer
    drops.  ``prev`` (the previous level's chunk width and subtraction
    flag) is for the sharded build's fetch; the whole cache needs none."""
    base, hist = cache
    idx = _pair_parents(parent, base, cs, s).clamp(0, hist.shape[-4] - 1)
    if parent.dim() == 1:
        return hist[idx]
    return hist[torch.arange(hist.shape[0], device=hist.device)[:, None],
                idx]


def _grow(step, route, arrays, assign, s_cap, max_nodes, level_callback,
          cursors=None, subtract=None, cache=None, max_depth=1 << 30,
          parent_rows=_parent_rows):
    """The level-synchronous queue (paper Algorithm 5), host-driven, for
    one tree or for L trees grown in DEPTH LOCKSTEP (a multiclass boosting
    round's class-trees).

    ``cursors`` = (level_start, level_end, next_free, depth): ``[L]`` int64
    host vectors and an int, by default every lane at its root; one tree
    is ``L = 1``.  A level's slot count follows its WIDEST lane, and
    narrower (or finished) lanes ride the extra chunks with ``chunk_n =
    0``.  Chunking does not change a tree, so each lane's tree is the one
    a build of that lane alone grows.

    ``step(arrays, assign, cs, cn, next_free, depth, num_slots,
    phist_pairs, use_sub, want_hist)`` returns (arrays, n_children, hist),
    ``n_children`` a 0-d or ``[L]`` tensor the host reads once a chunk;
    ``route(assign, arrays, start, end)`` returns the new per-example node
    assignment.  Both take the host vectors, as ``level_callback`` does
    its ``BuildState``: each build's closures (``_closures``) give each
    what its lane shape needs.

    ``subtract = (row_bytes, budget)`` enables sibling subtraction: each
    level's full histogram is cached (unless wider than ``budget /
    row_bytes`` slots) and the next level scatters only the smaller child of
    each split pair.  Past the root every lane's level width is even or
    zero, so ``use_sub`` / ``want_hist`` are shared.  ``parent_rows(parent,
    cache, cs, s, prev)`` fetches a chunk's parent rows from the cache,
    ``prev`` being the (chunk width, use_sub) of the level that filled it
    (the sharded build passes its own: there a rank may hold only its
    block of the cached slots).

    Each chunk counts its ``L * S`` slots as ``stack_slots`` and the ``cn``
    that hold a node as ``stack_slots_used``, from the host's cursors; a
    level too wide to cache counts one ``levels_uncached``."""
    if cursors is None:
        lanes = arrays["parent"].shape[:-1].numel()
        cursors = (np.zeros(lanes, np.int64), np.ones(lanes, np.int64),
                   np.ones(lanes, np.int64), 1)
    level_start, level_end, next_free, depth = cursors
    prev = None
    while (level_start < level_end).any():
        with tracing.span("tree.level"):
            widths = level_end - level_start
            wmax = int(widths.max())
            s = min(s_cap, max(16, 1 << (wmax - 1).bit_length()))
            # children are allocated in sibling pairs at (level_start + 2j,
            # level_start + 2j + 1); with even s and chunks starting at
            # level_start + i*s, pairs never straddle a chunk.  An odd s_cap
            # would misalign them, so round down.
            if subtract is not None and s % 2 and s > 1:
                s -= 1
            paired = s % 2 == 0
            use = (subtract is not None and cache is not None and paired
                   and bool((widths % 2 == 0).all()))
            # depth >= max_depth forces every node here to a leaf, so this
            # level has no children and caching its histogram would be
            # wasted
            wanted = subtract is not None and paired and depth < max_depth
            want = wanted and wmax * subtract[0] <= subtract[1]
            if wanted and not want:
                tracing.count("levels_uncached", 1)
            hists = []
            for i in range(0, wmax, s):
                cs = level_start + i
                cn = np.clip(widths - i, 0, s)
                with tracing.span("tree.chunk"):
                    tracing.count("stack_slots", cs.size * s)
                    tracing.count("stack_slots_used", cn.sum())
                    pp = (parent_rows(arrays["parent"][..., :max_nodes],
                                      cache, cs, s, prev) if use else None)
                    arrays, n_children, h = step(arrays, assign, cs, cn,
                                                 next_free, depth, s, pp, use,
                                                 want)
                with tracing.span("tree.children"):
                    next_free = next_free + tracing.to_host(n_children)
                if want:
                    hists.append(h)
            # the slot axis is dim -4 of one tree's [S, K, B, C] and of C
            # trees' [C, S, K, B, C]
            cache = ((level_start,
                      torch.cat(hists, dim=-4)[..., :wmax, :, :, :])
                     if want else None)
            prev = (s, use)
            with tracing.span("tree.route"):
                assign = route(assign, arrays, level_start, level_end)
        level_start, level_end = level_end, next_free
        depth += 1
        if level_callback is not None:
            level_callback(BuildState(
                {k: v[..., :max_nodes].clone() for k, v in arrays.items()},
                assign.clone(), level_start.copy(), level_end.copy(),
                next_free.copy(), depth,
                cache[1] if cache is not None else None,
                cache[0] if cache is not None else -1))
    return arrays, next_free


def _step_kw(config: TreeConfig, max_nodes: int, n_bins: int, lanes: int,
             n_label_bins: int = 1, weighted: bool = False) -> dict:
    """The chunk step's keywords: ``_chunk_step_classes``' for ``lanes``
    trees, ``_chunk_step``'s for one (``lanes`` 0)."""
    kw = dict(n_bins=n_bins, min_samples_split=config.min_samples_split,
              min_samples_leaf=config.min_samples_leaf,
              max_depth=config.max_depth, max_nodes=max_nodes,
              hist_backend=config.hist_backend,
              select_backend=config.select_backend,
              min_child_weight=config.min_child_weight)
    if not lanes:
        kw.update(heuristic=config.heuristic, task=config.task,
                  n_label_bins=n_label_bins, weighted=weighted)
    return kw


def _closures(chunk, route_fn, bins, rows, n_num, n_cat, weights, lanes,
              level_callback):
    """``_grow``'s ``step``, ``route`` and ``level_callback`` for a build:
    the one seam where a lane shape is decided.  ``chunk(bins, *rows,
    assign, arrays, phist_pairs, n_num, n_cat, cs, cn, next_free, depth,
    weights, num_slots=, use_sub=, want_hist=)`` is the chunk step with its
    keywords bound and ``route_fn`` takes ``_route_step``'s arguments.

    One tree (``lanes`` 0) gets the host ints of ``_grow``'s one-lane
    cursors, so no cursor is uploaded, and its ``level_callback`` a
    ``BuildState`` of ints.  C trees (``lanes`` C) upload theirs as one
    ``[3, C]`` int32 a chunk and one ``[2, C]`` a route, and their
    callback gets the ``[C]`` vectors."""
    def cursors(*xs):
        if not lanes:
            return [int(x[0]) for x in xs]
        return tracing.to_device(np.stack(xs), torch.int32, bins.device)

    def step(arrays, assign, cs, cn, next_free, depth, num_slots, pp,
             use_sub, want_hist):
        return chunk(bins, *rows, assign, arrays, pp, n_num, n_cat,
                     *cursors(cs, cn, next_free), depth, weights,
                     num_slots=num_slots, use_sub=use_sub,
                     want_hist=want_hist)

    def route(assign, arrays, start, end):
        cur = cursors(start, end)
        return route_fn(bins, assign, arrays, n_num,
                        *(cur[:, :, None] if lanes else cur))

    def one_tree(state):
        level_callback(state._replace(
            level_start=int(state.level_start[0]),
            level_end=int(state.level_end[0]),
            next_free=int(state.next_free[0]),
            phist_base=(-1 if state.phist is None
                        else int(state.phist_base[0]))))

    if level_callback is None or lanes:
        return step, route, level_callback
    return step, route, one_tree


def _lane_arrays(max_nodes: int, lanes: int, device) -> dict:
    """Fresh tree arrays with the drop slot: ``[max_nodes + 1]`` of one
    tree, ``[C, max_nodes + 1]`` of ``lanes`` = C."""
    arrays = _init_arrays(max_nodes + 1, device)
    if not lanes:
        return arrays
    return {k: v[None].repeat(lanes, 1) for k, v in arrays.items()}


def _tree_views(arrays, n_nodes, max_nodes: int):
    """A finished build's ``Tree`` of every lane and its tree arrays
    (``[max_nodes]`` or ``[C, max_nodes]``) without the drop slot."""
    arrays = {f: arrays[f][..., :max_nodes] for f in TREE_FIELDS}
    per_lane = {f: a.reshape(len(n_nodes), max_nodes)
                for f, a in arrays.items()}
    return [Tree(n_nodes=int(n), **{f: a[c] for f, a in per_lane.items()})
            for c, n in enumerate(n_nodes)], arrays


def _check_backends(config: TreeConfig) -> None:
    if config.hist_backend not in BACKENDS:
        raise ValueError(f"hist_backend {config.hist_backend!r}; have {BACKENDS}")
    if config.select_backend not in SELECT_BACKENDS:
        raise ValueError(f"select_backend {config.select_backend!r}; have "
                         f"{SELECT_BACKENDS}")
    if config.min_child_weight and config.select_backend == "kernel":
        raise ValueError("min_child_weight needs select_backend='torch' (the "
                         "split-scan kernel has no weight floor)")


def _resume_arrays(saved: dict, max_nodes: int, dev) -> dict:
    """A checkpointed state's ``[max_nodes]`` tree arrays (numpy or
    tensors, the reference's layout) with the port's drop slot appended."""
    arrays = _init_arrays(max_nodes + 1, dev)
    for f, dst in arrays.items():
        src = torch.as_tensor(saved[f], device=dev)
        if src.shape != (max_nodes,):
            raise ValueError(f"resume: {f} has shape {tuple(src.shape)}, this "
                             f"build has max_nodes={max_nodes}")
        dst[:max_nodes] = src.to(dst.dtype)
    return arrays


def _build_local(table: BinnedTable, config: TreeConfig, device, rows,
                 sample_weight, level_callback, assign0=None, resume=None):
    """``build_tree`` and ``build_trees_batched`` on ``device``.

    Under ``tree.upload``: the bins, ``rows(put)``, the weights, the
    feature vectors and ``assign0``.  ``rows`` returns the build's row
    operands, their statistic width, ``n_label_bins`` and the lanes (0 for
    one tree, C for C trees).  Then the node budget, the chunk-slot cap,
    the subtraction gate, and the level loop from the roots or from
    ``resume`` (one tree).  Returns the lanes' ``Tree`` views and their
    tree arrays."""
    dev = resolve_device(device)
    _check_backends(config)

    def put(x, dtype):
        return tracing.to_device(x, dtype, dev).contiguous()

    with tracing.span("tree.upload"):
        bins = put(table.bins, torch.int32)
        operands, c, n_label_bins, lanes = rows(put)
        weights = (None if sample_weight is None
                   else put(sample_weight, torch.float32))
        n_num = put(table.n_num, torch.int32)
        n_cat = put(table.n_cat, torch.int32)
        assign = None if assign0 is None else put(assign0, torch.int32)
    m, k = bins.shape
    b = int(table.n_bins)
    max_nodes = config.max_nodes or min(2 * m + 1, 1 << 22)
    s_cap = config.chunk_slots or _auto_chunk_slots(
        k, b, c, config.hist_budget_bytes)
    subtract = ((k * b * c * 4, config.sub_cache_bytes)
                if _subtract_eligible(config, m, weights is not None)
                else None)

    cursors = cache = None
    if resume is not None:
        arrays = _resume_arrays(resume.arrays, max_nodes, dev)
        assign = put(resume.assign, torch.int32)
        cursors = (*(np.array([v], np.int64) for v in (
            resume.level_start, resume.level_end, resume.next_free)),
            int(resume.depth))
        if resume.phist is not None:
            cache = (np.array([resume.phist_base], np.int64),
                     put(resume.phist, torch.float32))
    else:
        arrays = _lane_arrays(max_nodes, lanes, dev)
        lead = (lanes,) if lanes else ()
        assign = (torch.zeros((*lead, m), dtype=torch.int32, device=dev)
                  if assign is None else assign.expand(*lead, m).clone())

    chunk = functools.partial(
        _chunk_step_classes if lanes else _chunk_step,
        **_step_kw(config, max_nodes, b, lanes, n_label_bins,
                   weights is not None))
    step, route, callback = _closures(chunk, _route_step, bins, operands,
                                      n_num, n_cat, weights, lanes,
                                      level_callback)
    arrays, n_nodes = _grow(step, route, arrays, assign, s_cap, max_nodes,
                            callback, cursors, subtract=subtract, cache=cache,
                            max_depth=config.max_depth)
    return _tree_views(arrays, n_nodes, max_nodes)


def build_trees_batched(table: BinnedTable, z, config: TreeConfig,
                        sample_weight=None, assign0=None,
                        level_callback=None, device=None):
    """Build one ``regression_variance`` tree per row of ``z`` [C, M]
    through ONE level-synchronous build over a class axis (a multiclass
    boosting round's C class-trees), on ``device`` (``None`` means CUDA).

    ``z`` holds each class's Newton target on the SHARED binned table;
    ``sample_weight`` (optional [C, M]) its per-class hessian channel;
    ``assign0`` (optional [C, M] or [M] int32, -1 = inert row) seeds the
    example assignment.  Returns ``(trees, arrays)``: the per-class
    ``Tree`` views and the stacked ``[C, max_nodes]`` arrays.

    Each tree equals ``build_tree(table, z[c], config,
    sample_weight=sample_weight[c])`` field for field: every level chunk
    is one class-stacked histogram launch whose lanes equal one-lane
    launches, and one split-scan launch over the ``[C * S]`` slots."""
    if config.task != "regression_variance":
        raise ValueError("build_trees_batched fits 'regression_variance' "
                         f"trees (the boosting round task); got task="
                         f"{config.task!r}")
    with tracing.span("tree.build"):
        return _build_local(
            table, config, device,
            lambda put: ((put(z, torch.float32),), 3, 1, len(z)),
            sample_weight, level_callback, assign0=assign0)


def build_tree(table: BinnedTable, y, config: TreeConfig = TreeConfig(),
               n_classes: int | None = None, level_callback=None,
               resume: BuildState | None = None, sample_weight=None,
               device=None) -> Tree:
    """Train a UDT on ``device`` (``None`` means CUDA; ``"cpu"`` runs the
    kernels' plain versions).  ``y`` is int class ids (classification) or
    float targets (regression modes).  ``level_callback(BuildState)`` is
    invoked after each completed level; ``resume`` re-enters the build at
    the start of the level a checkpointed ``BuildState`` describes (its
    ``phist`` cache, when present, puts that level back on the sibling
    subtraction path), giving the uninterrupted tree.

    ``sample_weight`` (optional [M] f32) weights every histogram row, so
    node counts, labels and split scores become weighted;
    ``min_samples_split`` / ``min_samples_leaf`` then bound weighted counts
    (rounded to nearest).  Supported for "classification" (without sibling
    subtraction) and "regression_variance"; not for label-split
    "regression"."""
    if sample_weight is not None and config.task == "regression":
        raise ValueError("sample_weight is unsupported for the "
                         "label-split 'regression' task (use "
                         "'regression_variance')")

    def rows(put):
        stats, lbins, yv, c, n_label_bins = _operands(y, config, n_classes,
                                                      put)
        return (stats, lbins, yv), c, n_label_bins, 0

    with tracing.span("tree.build"):
        trees, _ = _build_local(table, config, device, rows, sample_weight,
                                level_callback, resume=resume)
    return trees[0]
