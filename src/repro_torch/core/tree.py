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
  * the sharded build's arguments (data / model axes, slot scatter) and
    ``resume=`` are not ported yet.
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
                                        node_histogram_sibling_fused)
from repro_torch.core.split import (NEG_INF, best_splits, best_splits_kernel,
                                    evaluate_predicate)

__all__ = ["TreeConfig", "Tree", "BuildState", "build_tree", "tree_from_numpy",
           "TREE_FIELDS"]

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
    cached for sibling subtraction."""
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

def _chunk_step(bins, stats, lbins, y, assign, arrays, phist_pairs, n_num,
                n_cat, chunk_start, chunk_n, next_free, depth, weights=None, *,
                num_slots, n_bins, heuristic, task, min_samples_split,
                min_samples_leaf, max_depth, max_nodes, hist_backend,
                select_backend, n_label_bins, use_sub=False, want_hist=False,
                weighted=False, min_child_weight=0.0):
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
    """
    s = num_slots
    dev = bins.device
    moment_task = task in ("regression", "regression_variance")

    def child_min_count(dec):
        cp = dec.pos_stats[:, 0] if moment_task else dec.pos_stats.sum(-1)
        cn = dec.neg_stats[:, 0] if moment_task else dec.neg_stats.sum(-1)
        return torch.minimum(torch.round(cp), torch.round(cn))       # [S] f32

    def select(hist, *, heuristic, min_leaf):
        fn = best_splits_kernel if select_backend == "kernel" else best_splits
        dec = fn(hist, n_num, n_cat, heuristic=heuristic, min_leaf=min_leaf)
        return dec, child_min_count(dec)

    slot_of_node = assign - chunk_start
    slot = torch.where((slot_of_node >= 0) & (slot_of_node < chunk_n),
                       slot_of_node, -1).to(torch.int32)
    slot_ids = torch.arange(s, dtype=torch.int32, device=dev)
    in_chunk = slot_ids < chunk_n
    # index max_nodes is the drop slot: writes the reference drops land there
    node_ids = torch.where(in_chunk, chunk_start + slot_ids, max_nodes)

    w = weights if weighted else None

    def build_hist(stats_rows):
        """One level-chunk histogram: full scatter, or smaller-child scatter
        plus sibling subtraction when the parent cache is available."""
        if not use_sub:
            return node_histogram(bins, stats_rows, slot, num_slots=s,
                                  n_bins=n_bins, backend=hist_backend,
                                  weights=w)
        # per-node routed-example counts decide which child to scatter;
        # rows with slot -1 fall into the extra bucket s and are dropped
        cnt = torch.zeros(s + 1, dtype=torch.float32, device=dev)
        cnt.index_add_(0, torch.where(slot >= 0, slot, s).long(),
                       torch.ones(slot.shape[0], dtype=torch.float32,
                                  device=dev))
        small_is_left = cnt[0:s:2] <= cnt[1:s:2]                   # [s/2]
        compute = torch.stack([small_is_left, ~small_is_left],
                              dim=1).reshape(s)
        # slots past chunk_n gather garbage parent rows; every downstream
        # write of those slots goes to the drop slot
        return node_histogram_sibling_fused(
            bins, stats_rows, slot, compute, phist_pairs, num_slots=s,
            n_bins=n_bins, backend=hist_backend, weights=w)

    if task == "regression":
        # Algorithm 6: per-node label split -> per-example pseudo class.
        lhist = node_histogram(lbins[:, None], moment_stats(y), slot,
                               num_slots=s, n_bins=n_label_bins,
                               backend=hist_backend)[:, 0]           # [S,Bl,3]
        tstar, label, count_f, sse = _label_split_thresholds(lhist)
        pseudo = lbins <= tstar[slot.clamp(0, s - 1).long()]
        stats = class_stats(pseudo, 2)
        count = torch.round(count_f).to(torch.int32)
        pure = sse <= 1e-10 * torch.clamp(count_f, min=1.0)
        hist = build_hist(stats)
        dec, mc = select(hist, heuristic=heuristic, min_leaf=min_samples_leaf)
    elif task == "regression_variance":
        hist = build_hist(moment_stats(y))
        tot = hist[:, 0].sum(dim=1)                                  # [S,3]
        count_f = tot[:, 0]
        safe = torch.where(count_f > 0, count_f, 1.0)
        label = tot[:, 1] / safe
        count = torch.round(count_f).to(torch.int32)
        pure = ((tot[:, 2] - tot[:, 1] ** 2 / safe)
                <= 1e-10 * torch.clamp(count_f, min=1.0))
        dec, mc = select(hist, heuristic="sse", min_leaf=min_samples_leaf)
    else:
        hist = build_hist(stats)
        tot = hist[:, 0].sum(dim=1)                                  # [S,C]
        count = torch.round(tot.sum(-1)).to(torch.int32)
        label = torch.argmax(tot, dim=-1).to(torch.float32)         # first max
        pure = tot.max(-1).values == tot.sum(-1)
        dec, mc = select(hist, heuristic=heuristic, min_leaf=min_samples_leaf)

    no_split = dec.score <= NEG_INF / 2
    is_leaf = (in_chunk & (pure | no_split
                           | (count < min_samples_split)
                           | (depth >= max_depth)))
    if min_child_weight:
        # mc is garbage where no_split holds -- already a leaf there
        is_leaf = is_leaf | (in_chunk & (mc <= min_child_weight))
    wants_split = in_chunk & ~is_leaf

    # allocate children; respect the node budget (overflow -> forced leaf)
    offs = torch.cumsum(wants_split.to(torch.int32), 0, dtype=torch.int32) - 1
    left = next_free + 2 * offs
    right = left + 1
    fits = right < max_nodes
    is_leaf = is_leaf | (wants_split & ~fits)
    wants_split = wants_split & fits
    n_children = 2 * wants_split.sum()

    left = torch.where(wants_split, left, -1)
    right = torch.where(wants_split, right, -1)

    def upd(name, vals, ids=node_ids):
        arrays[name][ids.long()] = vals.to(arrays[name].dtype)

    # child -> parent back-pointers: next level's sibling subtraction gathers
    # each pair's parent histogram row through these.
    for child in (left, right):
        upd("parent", node_ids, ids=torch.where(wants_split, child, max_nodes))

    upd("feat", torch.where(wants_split, dec.feat, -1))
    upd("op", torch.where(wants_split, dec.op, -1))
    upd("tbin", torch.where(wants_split, dec.bin, -1))
    upd("score", torch.where(wants_split, dec.score, NEG_INF))
    upd("label", label)
    upd("count", count)
    upd("depth", torch.full((s,), depth, dtype=torch.int32, device=dev))
    upd("left", left)
    upd("right", right)
    upd("leaf", is_leaf)
    return arrays, n_children, (hist if want_hist else None)


def _route_step(bins, assign, arrays, n_num, level_start, level_end):
    node = assign.long()
    left = arrays["left"][node]
    active = (assign >= level_start) & (assign < level_end) & (left >= 0)
    f = arrays["feat"][node].clamp(min=0).long()
    xb = bins.gather(1, f[:, None])[:, 0]
    pos = evaluate_predicate(xb, n_num[f], arrays["op"][node],
                             arrays["tbin"][node])
    nxt = torch.where(pos, left, arrays["right"][node])
    return torch.where(active, nxt, assign)


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


def _parent_rows(parent, cache, cs, s):
    """Gather each sibling pair's parent histogram row for one level chunk.

    ``cache`` is (base_node_id, H[level_width, K, B, C]) of the previous
    level; ``parent`` the [max_nodes] parent ids.  Ids past the array read
    -1 and every row index is clamped, as the reference's take/clip; pairs
    past the chunk's valid region gather garbage rows that every consumer
    drops."""
    base, hist = cache
    ids = cs + torch.arange(0, s, 2, device=parent.device)
    pid = torch.where(ids < parent.shape[0],
                      parent[ids.clamp(max=parent.shape[0] - 1)], -1)
    idx = (pid.long() - base).clamp(0, hist.shape[0] - 1)
    return hist[idx]


def _grow(step, route, arrays, assign, s_cap, max_nodes, level_callback,
          cursors=(0, 1, 1, 1), subtract=None, cache=None,
          max_depth=1 << 30):
    """The level-synchronous queue (paper Algorithm 5), host-driven.

    ``step(arrays, assign, cs, cn, next_free, depth, num_slots, phist_pairs,
    use_sub, want_hist)`` returns (arrays, n_children, hist); ``route(assign,
    arrays, start, end)`` returns the new per-example node assignment.

    ``subtract = (row_bytes, budget)`` enables sibling subtraction: each
    level's full histogram is cached (unless wider than ``budget /
    row_bytes`` slots) and the next level scatters only the smaller child of
    each split pair."""
    level_start, level_end, next_free, depth = cursors
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
            pp = (_parent_rows(arrays["parent"][:max_nodes], cache, cs, s)
                  if use else None)
            arrays, n_children, h = step(arrays, assign, cs, cn, next_free,
                                         depth, s, pp, use, want)
            next_free += int(n_children)
            if want:
                hists.append(h)
        cache = ((level_start, torch.cat(hists, dim=0)[:width])
                 if want else None)
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


def build_tree(table: BinnedTable, y, config: TreeConfig = TreeConfig(),
               n_classes: int | None = None, level_callback=None,
               sample_weight=None, device=None) -> Tree:
    """Train a UDT on ``device`` (``None`` means CUDA; ``"cpu"`` runs the
    kernels' plain versions).  ``y`` is int class ids (classification) or
    float targets (regression modes).  ``level_callback(BuildState)`` is
    invoked after each completed level.

    ``sample_weight`` (optional [M] f32) weights every histogram row, so
    node counts, labels and split scores become weighted;
    ``min_samples_split`` / ``min_samples_leaf`` then bound weighted counts
    (rounded to nearest).  Supported for "classification" (without sibling
    subtraction) and "regression_variance"; not for label-split
    "regression"."""
    dev = resolve_device(device)
    if config.hist_backend not in BACKENDS:
        raise ValueError(f"hist_backend {config.hist_backend!r}; have {BACKENDS}")
    if config.select_backend not in SELECT_BACKENDS:
        raise ValueError(f"select_backend {config.select_backend!r}; have "
                         f"{SELECT_BACKENDS}")
    if sample_weight is not None and config.task == "regression":
        raise ValueError("sample_weight is unsupported for the label-split "
                         "'regression' task (use 'regression_variance')")
    if config.min_child_weight and config.select_backend == "kernel":
        raise ValueError("min_child_weight needs select_backend='torch' (the "
                         "split-scan kernel has no weight floor)")
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
    arrays = _init_arrays(max_nodes + 1, dev)        # + the drop slot
    assign = torch.zeros((m,), dtype=torch.int32, device=dev)

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
                            level_callback, subtract=subtract,
                            max_depth=config.max_depth)
    return Tree(n_nodes=n_nodes,
                **{f: arrays[f][:max_nodes] for f in TREE_FIELDS})
