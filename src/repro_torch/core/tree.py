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
  * the loop is plain Python around eager torch ops; the host reads one
    scalar per chunk (the number of children allocated).
  * the multiclass build (``build_trees_batched``) writes the reference's
    ``vmap`` over a class axis out: ``[C]`` cursors, ``[C, max_nodes + 1]``
    tree arrays, ``assign [C, M]``, and ONE class-stacked histogram launch
    and one split-scan launch per level chunk for every class; the host
    reads one ``[C]`` vector per chunk.
  * the sharded build (``core.distributed``) runs these same steps in one
    process per rank with ``comm`` (``core.collectives.Collectives``),
    ``data_axes``, ``model_axis`` and ``slot_scatter``: the reference's
    ``shard_map`` body with ``torch.distributed`` collectives.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.binning import BinnedTable
from repro_torch.core.histogram import (BACKENDS, class_stats, moment_stats,
                                        node_histogram,
                                        node_histogram_sibling_fused,
                                        node_histogram_sibling_fused_stacked,
                                        node_histogram_smaller_child,
                                        node_histogram_smaller_child_stacked,
                                        node_histogram_stacked)
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
        return int(d.max()) if d.numel() else 0


class BuildState(NamedTuple):
    """Per-level build state, handed to ``level_callback`` after each level.

    ``phist`` / ``phist_base`` carry the completed level's full histogram
    (``[level_width, K, B, C]``, base node id ``phist_base``) when it was
    cached for sibling subtraction.  ``build_tree(resume=...)`` re-enters
    the build from one (``checkpoint.tree_ckpt``); the batched build's
    states carry a leading class axis and ``[C]`` numpy cursors."""
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


def _smaller_child_mask(slot, num_slots, reduce=None):
    """[..., S] "scatter me" mask of sibling subtraction: per pair the child
    with fewer routed rows (the left one on a tie).  Rows with slot -1 fall
    into an extra bucket per tree and are dropped.  ``reduce`` (the psum
    over the data axes of a sharded build) makes the counts global, so
    every data shard picks the same child."""
    s = num_slots
    lead = slot.shape[:-1]
    n = slot[..., 0].numel()
    tree = torch.arange(n, device=slot.device).view(*lead, 1) * (s + 1)
    cnt = torch.zeros(n * (s + 1), dtype=torch.float32, device=slot.device)
    cnt.index_add_(0, (torch.where(slot >= 0, slot, s) + tree).reshape(-1)
                   .long(), torch.ones(slot.numel(), dtype=torch.float32,
                                       device=slot.device))
    cnt = cnt.view(*lead, s + 1)[..., :s]
    if reduce is not None:
        cnt = reduce(cnt)
    small_is_left = cnt[..., 0::2] <= cnt[..., 1::2]
    return torch.stack([small_is_left, ~small_is_left], dim=-1).reshape(
        *lead, s)


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
    With data axes the smaller child and the subtraction are separate
    steps; only ``data_axes=()`` keeps the kernel's fused epilogue.
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
        # write of those slots goes to the drop slot
        compute = _smaller_child_mask(slot, s,
                                      _counts_psum(comm, data_axes))
        if not data_axes:
            return node_histogram_sibling_fused(
                bins, stats_rows, slot, compute, phist_pairs, num_slots=s,
                n_bins=n_bins, backend=hist_backend, weights=w)
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
    else:
        compute = _smaller_child_mask(slot, s,
                                      _counts_psum(comm, data_axes))
        if not data_axes:
            hist = node_histogram_sibling_fused_stacked(
                bins, stats, slot, compute, phist_pairs, num_slots=s,
                n_bins=n_bins, backend=hist_backend, weights=weights)
        else:
            h_small = _reduce_data(node_histogram_smaller_child_stacked(
                bins, stats, slot, compute, num_slots=s, n_bins=n_bins,
                backend=hist_backend, weights=weights), comm, data_axes,
                scatter, dim=1)
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
    f = at("feat").clamp(min=0).long()
    if model_axis is not None:
        k_local = bins.shape[1]
        mine = (f // k_local) == comm.axis_index(model_axis)
        f = torch.where(mine, f % k_local, 0)
    xb = bins.t().gather(0, f.view(-1, f.shape[-1])).view_as(f)  # bins[i, f]
    pos = evaluate_predicate(xb, n_num[f], at("op"), at("tbin"))
    if model_axis is not None:
        pos = comm.psum((pos & mine).to(torch.int32), (model_axis,),
                        "route") > 0
    return torch.where(active, torch.where(pos, left, at("right")), assign)


# ---------------------------------------------------------------------------
# host-driven level loop (paper Algorithm 5's queue, one level per tick)
# ---------------------------------------------------------------------------

def _prepare(table: BinnedTable, y, config: TreeConfig,
             n_classes: int | None):
    """Input prep: (bins, stats, lbins, y, C, n_label_bins), numpy or tensors.

    Classification needs the class count; label-split regression pre-bins
    the labels once on the host; ``regression_variance`` takes ``y`` as it
    comes (numpy or a tensor) and its stats / lbins are dead operands."""
    bins = table.bins
    m, k = bins.shape
    if config.task == "regression_variance":
        return (bins, np.zeros((m, 3), np.float32), np.zeros((m,), np.int32),
                y, 3, 1)
    if config.task == "classification":
        y = np.asarray(y)
        c = int(n_classes if n_classes is not None else int(y.max()) + 1)
        stats = np.eye(c, dtype=np.float32)[np.asarray(y, dtype=np.int64)]
        lbins = np.zeros((m,), dtype=np.int32)
        yv = np.zeros((m,), dtype=np.float32)
        n_label_bins = 1
    else:
        yv = np.asarray(y, dtype=np.float32)
        c = 2
        stats = np.zeros((m, c), dtype=np.float32)
        # bin the labels once (the paper pre-sorts them once) for Alg. 6
        yy = np.asarray(y, dtype=np.float64)
        uniq = np.unique(yy)
        if uniq.size > config.n_label_bins:
            edges = np.unique(np.quantile(
                yy, np.linspace(0, 1, config.n_label_bins), method="nearest"))
        else:
            edges = uniq
        lb = np.minimum(np.searchsorted(edges, yy, side="left"),
                        len(edges) - 1)
        lbins = lb.astype(np.int32)
        n_label_bins = int(len(edges))
    return bins, stats, lbins, yv, c, n_label_bins


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


def _parent_rows(parent, cache, cs, s, prev=None):
    """Gather each sibling pair's parent histogram row for one level chunk.

    ``cache`` is (base_node_id, H[level_width, K, B, C]) of the previous
    level; ``parent`` the [max_nodes] parent ids.  Ids past the array read
    -1 and every row index is clamped, as the reference's take/clip; pairs
    past the chunk's valid region gather garbage rows that every consumer
    drops.  ``prev`` (the previous level's chunk width and subtraction
    flag) is for the sharded build's fetch; the whole cache needs none."""
    base, hist = cache
    ids = cs + torch.arange(0, s, 2, device=parent.device)
    pid = torch.where(ids < parent.shape[0],
                      parent[ids.clamp(max=parent.shape[0] - 1)], -1)
    idx = (pid.long() - base).clamp(0, hist.shape[0] - 1)
    return hist[idx]


def _grow(step, route, arrays, assign, s_cap, max_nodes, level_callback,
          cursors=(0, 1, 1, 1), subtract=None, cache=None,
          max_depth=1 << 30, parent_rows=_parent_rows):
    """The level-synchronous queue (paper Algorithm 5), host-driven.

    ``step(arrays, assign, cs, cn, next_free, depth, num_slots, phist_pairs,
    use_sub, want_hist)`` returns (arrays, n_children, hist); ``route(assign,
    arrays, start, end)`` returns the new per-example node assignment.

    ``subtract = (row_bytes, budget)`` enables sibling subtraction: each
    level's full histogram is cached (unless wider than ``budget /
    row_bytes`` slots) and the next level scatters only the smaller child of
    each split pair.  ``parent_rows(parent, cache, cs, s, prev)`` fetches
    a chunk's parent rows from the cache, ``prev`` being the (chunk width,
    use_sub) of the level that filled it (the sharded build passes its own:
    there a rank may hold only its block of the cached slots)."""
    level_start, level_end, next_free, depth = cursors
    prev = None
    while level_start < level_end:
        width = level_end - level_start
        s = min(s_cap, max(16, 1 << (width - 1).bit_length()))
        # children are allocated in sibling pairs at (level_start + 2j,
        # level_start + 2j + 1); with even s and chunks starting at
        # level_start + i*s, pairs never straddle a chunk.  An odd s_cap
        # would misalign them, so round down.
        if subtract is not None and s % 2 and s > 1:
            s -= 1
        paired = s % 2 == 0
        use = (subtract is not None and cache is not None and paired
               and width % 2 == 0)
        # depth >= max_depth forces every node here to a leaf, so this
        # level has no children and caching its histogram would be wasted
        want = (subtract is not None and paired and depth < max_depth
                and width * subtract[0] <= subtract[1])
        hists = []
        for cs in range(level_start, level_end, s):
            cn = min(s, level_end - cs)
            pp = (parent_rows(arrays["parent"][:max_nodes], cache, cs, s,
                              prev) if use else None)
            arrays, n_children, h = step(arrays, assign, cs, cn, next_free,
                                         depth, s, pp, use, want)
            next_free += int(n_children)
            if want:
                hists.append(h)
        cache = ((level_start, torch.cat(hists, dim=0)[:width])
                 if want else None)
        prev = (s, use)
        assign = route(assign, arrays, level_start, level_end)
        level_start, level_end = level_end, next_free
        depth += 1
        if level_callback is not None:
            level_callback(BuildState(
                {k: v[:max_nodes].clone() for k, v in arrays.items()},
                assign.clone(), level_start, level_end, next_free, depth,
                cache[1] if cache is not None else None,
                cache[0] if cache is not None else -1))
    return arrays, next_free


def _parent_rows_batched(parent, cache, cs, s, prev=None):
    """Per-class parent histogram rows: ``cache`` is (base [C] numpy, H[C,
    W, K, B, C']) of the previous level, ``parent`` the [C, max_nodes]
    parent ids, ``cs`` the [C] chunk starts; ``_parent_rows`` per class."""
    base, hist = cache
    dev = parent.device
    n = parent.shape[1]
    ids = (torch.as_tensor(cs, device=dev)[:, None]
           + torch.arange(0, s, 2, device=dev))
    pid = torch.where(ids < n, parent.gather(1, ids.clamp(max=n - 1)), -1)
    idx = (pid.long() - torch.as_tensor(base, device=dev)[:, None]).clamp(
        0, hist.shape[1] - 1)
    return hist[torch.arange(hist.shape[0], device=dev)[:, None], idx]


def _grow_batched(step, route, arrays, assign, s_cap, max_nodes,
                  level_callback, n_stack, subtract=None, max_depth=1 << 30,
                  parent_rows=_parent_rows_batched):
    """``_grow`` for ``n_stack`` trees grown in DEPTH LOCKSTEP through one
    batched step (the multiclass boosting round): the level cursors become
    per-class ``[C]`` numpy vectors, the chunk count per level follows the
    WIDEST class, and narrower (or finished) classes ride the extra chunks
    as ``chunk_n = 0`` lanes.  Chunking does not change the trees, so each
    class's tree is the one ``_grow`` builds for that class alone.

    ``step(arrays, assign, cs, cn, next_free, depth, num_slots,
    phist_pairs, use_sub, want_hist)`` takes the cursors as [C] numpy
    vectors and returns (arrays, n_children [C] tensor, hist); the host
    reads ``n_children`` once per chunk.  Past the root every class's level
    width is even or zero, so ``use_sub`` / ``want_hist`` are shared; the
    cached level histogram is padded to the widest class.  ``parent_rows``
    is ``_grow``'s, over the class axis."""
    level_start = np.zeros(n_stack, dtype=np.int64)
    level_end = np.ones(n_stack, dtype=np.int64)
    next_free = np.ones(n_stack, dtype=np.int64)
    depth = 1
    cache = prev = None
    while (level_start < level_end).any():
        widths = level_end - level_start
        wmax = int(widths.max())
        s = min(s_cap, max(16, 1 << (wmax - 1).bit_length()))
        if subtract is not None and s % 2 and s > 1:
            s -= 1
        paired = s % 2 == 0
        use = (subtract is not None and cache is not None and paired
               and bool((widths % 2 == 0).all()))
        want = (subtract is not None and paired and depth < max_depth
                and wmax * subtract[0] <= subtract[1])
        hists = []
        for i in range(0, wmax, s):
            cs = level_start + i
            cn = np.clip(level_end - cs, 0, min(s, wmax - i))
            pp = (parent_rows(arrays["parent"][:, :max_nodes], cache, cs, s,
                              prev) if use else None)
            arrays, n_children, h = step(arrays, assign, cs, cn, next_free,
                                         depth, s, pp, use, want)
            next_free = next_free + n_children.cpu().numpy().astype(np.int64)
            if want:
                hists.append(h)
        cache = ((level_start.copy(), torch.cat(hists, dim=1)[:, :wmax])
                 if want else None)
        prev = (s, use)
        assign = route(assign, arrays, level_start, level_end)
        level_start, level_end = level_end, next_free.copy()
        depth += 1
        if level_callback is not None:
            level_callback(BuildState(
                {k: v[:, :max_nodes].clone() for k, v in arrays.items()},
                assign.clone(), level_start.copy(), level_end.copy(),
                next_free.copy(), depth,
                cache[1] if cache is not None else None,
                cache[0] if cache is not None else -1))
    return arrays, next_free


def _check_backends(config: TreeConfig) -> None:
    if config.hist_backend not in BACKENDS:
        raise ValueError(f"hist_backend {config.hist_backend!r}; have {BACKENDS}")
    if config.select_backend not in SELECT_BACKENDS:
        raise ValueError(f"select_backend {config.select_backend!r}; have "
                         f"{SELECT_BACKENDS}")
    if config.min_child_weight and config.select_backend == "kernel":
        raise ValueError("min_child_weight needs select_backend='torch' (the "
                         "split-scan kernel has no weight floor)")


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
    _check_backends(config)
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).contiguous()

    bins = put(table.bins, torch.int32)
    m, k = bins.shape
    b = int(table.n_bins)
    z = put(z, torch.float32)
    n_stack = z.shape[0]
    weights = (None if sample_weight is None
               else put(sample_weight, torch.float32))
    n_num = put(table.n_num, torch.int32)
    n_cat = put(table.n_cat, torch.int32)

    max_nodes = config.max_nodes or min(2 * m + 1, 1 << 22)
    s_cap = config.chunk_slots or _auto_chunk_slots(
        k, b, 3, config.hist_budget_bytes)
    arrays = {k_: v[None].repeat(n_stack, 1)                # + the drop slot
              for k_, v in _init_arrays(max_nodes + 1, dev).items()}
    if assign0 is None:
        assign = torch.zeros((n_stack, m), dtype=torch.int32, device=dev)
    else:
        assign = put(assign0, torch.int32).expand(n_stack, m).clone()
    subtract = ((k * b * 3 * 4, config.sub_cache_bytes)
                if _subtract_eligible(config, m, weights is not None)
                else None)

    kw = dict(n_bins=b, min_samples_split=config.min_samples_split,
              min_samples_leaf=config.min_samples_leaf,
              max_depth=config.max_depth, max_nodes=max_nodes,
              hist_backend=config.hist_backend,
              select_backend=config.select_backend,
              min_child_weight=config.min_child_weight)

    def step(arrays, assign, cs, cn, next_free, depth, num_slots, pp,
             use_sub, want_hist):
        cur = torch.as_tensor(np.stack([cs, cn, next_free]),
                              dtype=torch.int32).to(dev)
        return _chunk_step_classes(bins, z, assign, arrays, pp, n_num, n_cat,
                                   cur[0], cur[1], cur[2], depth, weights,
                                   num_slots=num_slots, use_sub=use_sub,
                                   want_hist=want_hist, **kw)

    def route(assign, arrays, start, end):
        cur = torch.as_tensor(np.stack([start, end]),
                              dtype=torch.int32).to(dev)
        return _route_step(bins, assign, arrays, n_num, cur[0][:, None],
                           cur[1][:, None])

    arrays, n_nodes = _grow_batched(step, route, arrays, assign, s_cap,
                                    max_nodes, level_callback, n_stack,
                                    subtract=subtract,
                                    max_depth=config.max_depth)
    arrays = {f: arrays[f][:, :max_nodes] for f in TREE_FIELDS}
    trees = [Tree(n_nodes=int(n_nodes[c]),
                  **{f: arrays[f][c] for f in TREE_FIELDS})
             for c in range(n_stack)]
    return trees, arrays


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
    dev = resolve_device(device)
    _check_backends(config)
    if sample_weight is not None and config.task == "regression":
        raise ValueError("sample_weight is unsupported for the label-split "
                         "'regression' task (use 'regression_variance')")
    bins_h, stats_h, lbins_h, yv_h, c, n_label_bins = _prepare(
        table, y, config, n_classes)
    m, k = bins_h.shape
    b = int(table.n_bins)

    def put(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).contiguous()

    bins = put(bins_h, torch.int32)
    stats = put(stats_h, torch.float32)
    lbins = put(lbins_h, torch.int32)
    yv = put(yv_h, torch.float32)
    weights = (None if sample_weight is None
               else put(sample_weight, torch.float32))
    n_num = put(table.n_num, torch.int32)
    n_cat = put(table.n_cat, torch.int32)

    max_nodes = config.max_nodes or min(2 * m + 1, 1 << 22)
    s_cap = config.chunk_slots or _auto_chunk_slots(
        k, b, c, config.hist_budget_bytes)
    cache = None
    if resume is not None:
        arrays = _resume_arrays(resume.arrays, max_nodes, dev)
        assign = put(resume.assign, torch.int32)
        cursors = (int(resume.level_start), int(resume.level_end),
                   int(resume.next_free), int(resume.depth))
        if resume.phist is not None:
            cache = (int(resume.phist_base), put(resume.phist, torch.float32))
    else:
        arrays = _init_arrays(max_nodes + 1, dev)    # + the drop slot
        assign = torch.zeros((m,), dtype=torch.int32, device=dev)
        cursors = (0, 1, 1, 1)

    subtract = ((k * b * c * 4, config.sub_cache_bytes)
                if _subtract_eligible(config, m, weights is not None)
                else None)

    kw = dict(n_bins=b, heuristic=config.heuristic, task=config.task,
              min_samples_split=config.min_samples_split,
              min_samples_leaf=config.min_samples_leaf,
              max_depth=config.max_depth, max_nodes=max_nodes,
              hist_backend=config.hist_backend,
              select_backend=config.select_backend,
              n_label_bins=n_label_bins, weighted=weights is not None,
              min_child_weight=config.min_child_weight)

    def step(arrays, assign, cs, cn, next_free, depth, num_slots, pp,
             use_sub, want_hist):
        return _chunk_step(bins, stats, lbins, yv, assign, arrays, pp, n_num,
                           n_cat, cs, cn, next_free, depth, weights,
                           num_slots=num_slots, use_sub=use_sub,
                           want_hist=want_hist, **kw)

    def route(assign, arrays, start, end):
        return _route_step(bins, assign, arrays, n_num, start, end)

    arrays, n_nodes = _grow(step, route, arrays, assign, s_cap, max_nodes,
                            level_callback, cursors, subtract=subtract,
                            cache=cache, max_depth=config.max_depth)
    return Tree(n_nodes=n_nodes,
                **{f: arrays[f][:max_nodes] for f in TREE_FIELDS})
