"""Training-Only-Once Tuning (paper section 3) as a design-space engine, in
torch.

Counterpart of ``repro.core.tuning``.  Train ONE full model, then price the
whole hyper-parameter design space against the validation set without
retraining: record each validation example's root->leaf path once.  Along
a path

  * node counts are non-increasing, so for any ``min_samples_split`` the
    stopping index is a prefix count (``sum(count >= smin)``);
  * the running minimum of each node's lighter-child count is
    non-increasing, so ``min_child_weight`` is a second prefix cutoff --
    exact because the builder applies it as a post-selection stopping
    rule, never a candidate mask (``TreeConfig``);
  * ``max_depth`` is a clamp.

Every grid cell then costs O(1) per example; ``sweep`` prices the whole
``(max_depth x min_samples_split x min_child_weight)`` grid on the device
and -- for ``GradientBoostedTrees`` -- adds ``n_rounds`` as a prefix sum
over per-round path tables: round r's trees never depend on predict-time
pruning, and the fit draws its GOSS samples round by round from one
generator, so the first r trees of one fit ARE the retrained r-round
ensemble.

Cost joins quality: each cell's pruned node count and predicted serve
bytes (``serve.pack.walk_bytes_per_request`` at the pruned depth) come
from a host-side dominance count over per-node reachability thresholds,
and ``SweepResult.front`` is the non-dominated cost/quality Pareto set.

The paper's protocol (section 4): max_depth swept 1..full tree depth;
min_split swept 0..4% of the training set in steps of 0.02% (200 values).

Exactness: classification metrics are int32 correct-prediction counts on
the device, divided on the host in float64, so a cell equals retraining
with that cell's hyper-parameters bit for bit.  Regression cells sum
squared error in f32 and are compared to tolerance.  ``sweep(tree, ...,
mesh=, dist=)`` prices a single tree's grid on a ``DeviceMesh``
(``core.distributed.sharded_grid_counts``): the same int32 counts.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch._device import resolve_device
from repro_torch.core.predict import WALK_FIELDS, _paths
from repro_torch.core.tree import Tree
from repro_torch.serve.pack import (predict_record_bytes,
                                    walk_bytes_per_request)

__all__ = ["ToolGrid", "toot_grid", "tune", "prune_stats", "TuneResult",
           "SweepSpace", "SweepResult", "ParetoPoint", "sweep",
           "path_tables", "pareto_front", "default_smin_values"]


class ToolGrid(NamedTuple):
    dmax: np.ndarray      # [Nd]
    smin: np.ndarray      # [Ns]
    metric: np.ndarray    # [Nd, Ns] accuracy (cls) or -RMSE (reg): higher=better


@dataclasses.dataclass
class TuneResult:
    best_dmax: int
    best_smin: int
    best_metric: float
    grid: ToolGrid
    n_configs: int
    best_nodes: int = -1      # pruned node count of the winning config


class ParetoPoint(NamedTuple):
    metric: float        # higher is better (accuracy / -RMSE)
    n_nodes: int         # pruned node count (summed over rounds)
    walk_bytes: int      # predicted serve.pack.walk_bytes_per_request
    config: dict         # the hyper-parameters that price to this point


@dataclasses.dataclass(frozen=True)
class SweepSpace:
    """The design space ``sweep`` prices.  ``None`` axes resolve to the
    paper protocol: max_depth 1..full depth, min_samples_split the
    200-value 0..4% ramp, min_child_weight disabled (a single 0.0), and --
    ensembles -- n_rounds 1..n_trees."""
    dmax_values: tuple | None = None
    smin_values: tuple | None = None
    mcw_values: tuple = (0.0,)
    n_rounds_values: tuple | None = None   # ensembles only


@dataclasses.dataclass
class SweepResult:
    dmax: np.ndarray            # [Nd]
    smin: np.ndarray            # [Ns]
    mcw: np.ndarray             # [Nw]
    n_rounds: np.ndarray | None  # [R] (None for single trees)
    metric: np.ndarray          # [Nd,Ns,Nw] or [R,Nd,Ns,Nw]; higher=better
    n_nodes: np.ndarray         # same shape, pruned node count per cell
    walk_bytes: np.ndarray      # same shape, predicted serve bytes/request
    front: list                 # non-dominated ParetoPoint, metric-desc
    best: ParetoPoint           # max metric; ties -> cheapest (see tune)
    n_configs: int


def default_smin_values(train_size: int) -> np.ndarray:
    """Paper protocol: min_split 0 .. 4% of the train set in steps of
    0.02% -- exactly 200 values (the 4% endpoint is excluded)."""
    return np.round(np.arange(200) * (0.0002 * train_size)).astype(np.int32)


# ---------------------------------------------------------------------------
# path tables: one root->leaf walk per example, three [M, T] tables
# ---------------------------------------------------------------------------

def _node_child_min(ta):
    """Per node: the lighter child's recorded count (f32; +inf on leaves),
    the statistic the builder's min_child_weight rule and the predict
    walk's runtime gate both compare."""
    left, right = ta["left"].long(), ta["right"].long()
    internal = (~ta["leaf"]) & (left >= 0)
    cnt = ta["count"]
    mc = torch.minimum(cnt[left.clamp(min=0)],
                       cnt[right.clamp(min=0)]).to(torch.float32)
    return torch.where(internal, mc, torch.inf)


def path_tables(tree: Tree, val_bins, n_num, *, num_steps: int | None = None,
                device=None):
    """Record each validation example's path once: ``(lab, cnt, cmc)``
    [M, T] tables on ``device`` (``None`` means CUDA), stay-at-leaf past
    the leaf.

    ``lab`` / ``cnt`` are the path nodes' labels and counts; ``cmc`` is the
    running minimum of the lighter-child count along the path (what makes
    the min_child_weight axis a prefix cutoff)."""
    dev = resolve_device(device)
    ta = {f: getattr(tree, f).to(dev) for f in WALK_FIELDS}
    steps = num_steps if num_steps is not None else max(1, tree.max_tree_depth)
    nodes = _paths(ta, tracing.to_device(val_bins, torch.int32, dev),
                   tracing.to_device(n_num, torch.int32, dev),
                   max(1, steps)).long()                          # [M, T]
    lab = ta["label"][nodes]
    cnt = ta["count"][nodes]
    cmc = torch.cummin(_node_child_min(ta)[nodes], dim=1).values
    return lab, cnt, cmc


# ---------------------------------------------------------------------------
# the grid counts
# ---------------------------------------------------------------------------

def _stop_indices(cnt, cmc, smin, mcw):
    """First-failing path index per (example, smin) and (example, mcw):
    each gate fails monotonically along a path, so the first failure is a
    prefix count, and a cell's stopping index is the min over gates."""
    idx_s = (cnt[:, :, None] >= smin[None, None, :]).sum(1).to(torch.int32)
    # mcw <= 0 disables the gate -- the predict walk's rule
    pass_w = (mcw[None, None, :] <= 0) | (cmc[:, :, None] > mcw[None, None, :])
    idx_w = pass_w.sum(1).to(torch.int32)
    return idx_s, idx_w                                  # [M,Ns], [M,Nw]


def _stop(cnt, cmc, smin, mcw):
    """[M, Ns, Nw] stopping index of every (smin, mcw) cell."""
    idx_s, idx_w = _stop_indices(cnt, cmc, smin, mcw)
    return torch.minimum(idx_s[:, :, None], idx_w[:, None, :])


def _labels_at(lab, stop, d):
    """[M, Ns*Nw] label each example stops at under max_depth ``d`` (a 0-d
    tensor on ``stop``'s device: the clamp stays there, no host read)."""
    m, t_len = lab.shape
    idx = torch.minimum(stop, d - 1).clamp(0, t_len - 1)
    return torch.gather(lab, 1, idx.reshape(m, -1).long())


def _grid_counts(lab, cnt, cmc, y, valid, smin, mcw, dmax, *,
                 classification: bool = True):
    """[Nd, Ns, Nw] per-cell totals: int32 correct-prediction counts
    (classification) or f32 SSE sums (regression).  A loop over dmax keeps
    the peak intermediate at [M, Ns, Nw]; it counts the axis's length, so
    no value of ``dmax`` is read on the host."""
    ns, nw = smin.shape[0], mcw.shape[0]
    stop = _stop(cnt, cmc, smin, mcw)
    out = []
    for i in range(dmax.shape[0]):
        pred = _labels_at(lab, stop, dmax[i]).reshape(-1, ns, nw)
        if classification:
            ok = (pred == y[:, None, None]) & valid[:, None, None]
            out.append(ok.sum(dim=0).to(torch.int32))
        else:
            err = torch.where(valid[:, None, None],
                              (pred - y[:, None, None]) ** 2, 0.0)
            out.append(err.sum(dim=0))
    return torch.stack(out)                                       # [Nd,Ns,Nw]


def _ensemble_grid_counts(tables, y, valid, smin, mcw, dmax, lr, base, *,
                          logistic: bool = True):
    """[R, Nd, Ns, Nw] per-prefix totals for a boosted ensemble.

    A loop over rounds carries the accumulated raw scores of EVERY (dmax,
    smin, mcw) cell and emits the totals after each round.  The carry
    update is ``raw + lr * contrib``, two f32 ops as in the fit's score
    update, so prefix r's raw scores equal the r-round refit's bit for
    bit."""
    nd, ns, nw = dmax.shape[0], smin.shape[0], mcw.shape[0]
    m = y.shape[0]
    raw = base.expand(nd, m, ns * nw)
    outs = []
    for lab, cnt, cmc in tables:
        stop = _stop(cnt, cmc, smin, mcw)
        contrib = torch.stack([_labels_at(lab, stop, dmax[i])
                               for i in range(nd)])              # [Nd,M,Ns*Nw]
        raw = raw + lr * contrib
        if logistic:
            ok = (raw > 0) == (y[None, :, None] > 0.5)
            outs.append((ok & valid[None, :, None]).sum(dim=1)
                        .to(torch.int32))
        else:
            err = torch.where(valid[None, :, None],
                              (raw - y[None, :, None]) ** 2, 0.0)
            outs.append(err.sum(dim=1))
    return torch.stack(outs).reshape(len(tables), nd, ns, nw)


# ---------------------------------------------------------------------------
# the cost model: pruned node count / depth per cell, host-side
# ---------------------------------------------------------------------------

def _host(t):
    return tracing.to_host(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _node_thresholds(tree: Tree):
    """Per-node reachability thresholds (host numpy).  Node u is visited by
    the pruned walk under ``(dmax, smin, mcw)`` iff

        depth[u] <= dmax  and  pcount[u] >= smin  and  mcw < pmc[u]

    with ``pcount`` the parent's count (+inf at the root) and ``pmc`` the
    min over strict ancestors of the lighter-child count (+inf at the
    root).  Parents precede children in node-id order, so one forward pass
    computes both; the semantics match ``prune_stats``' walk."""
    n = tree.n_nodes
    depth = _host(tree.depth)[:n].astype(np.int64)
    count = _host(tree.count)[:n].astype(np.float64)
    left = _host(tree.left)[:n]
    right = _host(tree.right)[:n]
    leaf = _host(tree.leaf)[:n]
    parent = _host(tree.parent)[:n]
    internal = (~leaf) & (left >= 0)
    mc = np.full(n, np.inf)
    mc[internal] = np.minimum(count[left[internal]], count[right[internal]])
    pcount = np.full(n, np.inf)
    pmc = np.full(n, np.inf)
    for u in range(1, n):
        p = parent[u]
        pcount[u] = count[p]
        pmc[u] = min(pmc[p], mc[p])
    return depth, pcount, pmc


def _cost_grids(tree: Tree, dmax_values, smin_values, mcw_values):
    """Pruned ``(node count, max depth)`` of EVERY grid cell: bucket each
    node at its per-axis threshold indices, then running-sum (count) /
    running-max (depth) along each axis -- O(n_nodes + grid).  Axes may
    repeat values in any order; the work uses the unique sorted axes and
    scatters back."""
    depth, pcount, pmc = _node_thresholds(tree)
    ds, d_inv = np.unique(np.asarray(dmax_values), return_inverse=True)
    ss, s_inv = np.unique(np.asarray(smin_values), return_inverse=True)
    ws, w_inv = np.unique(np.asarray(mcw_values, dtype=np.float64),
                          return_inverse=True)
    nd, ns, nw = len(ds), len(ss), len(ws)
    # the walk's mcw gate passes when mcw <= 0 whatever pmc is
    pmc = np.where(pmc > 0, pmc, np.nextafter(0, 1))
    di = np.searchsorted(ds, depth, side="left")         # first dmax >= depth
    si = np.searchsorted(ss, pcount, side="right") - 1   # last smin <= pcount
    wi = np.searchsorted(ws, pmc, side="left") - 1       # last mcw < pmc
    keep = (di < nd) & (si >= 0) & (wi >= 0)
    di, si, wi, dep = di[keep], si[keep], wi[keep], depth[keep]

    g = np.zeros((nd, ns, nw), dtype=np.int64)
    np.add.at(g, (di, si, wi), 1)
    g = np.cumsum(g, axis=0)
    g = np.flip(np.cumsum(np.flip(g, 1), axis=1), 1)
    g = np.flip(np.cumsum(np.flip(g, 2), axis=2), 2)

    h = np.zeros((nd, ns, nw), dtype=np.int64)
    np.maximum.at(h, (di, si, wi), dep)
    h = np.maximum.accumulate(h, axis=0)
    h = np.flip(np.maximum.accumulate(np.flip(h, 1), axis=1), 1)
    h = np.flip(np.maximum.accumulate(np.flip(h, 2), axis=2), 2)

    sel = np.ix_(d_inv, s_inv, w_inv)
    return g[sel], h[sel]


def _predicted_record_bytes(trees) -> int:
    """Packed record width predicted from the models' field ranges (the
    serve packer's per-field int8 -> int16 -> int32 rule)."""
    n_feat = max(int(_host(t.feat)[:t.n_nodes].max()) + 1 for t in trees)
    n_bins = max(int(_host(t.tbin)[:t.n_nodes].max()) + 1 for t in trees)
    max_loff = 0
    for t in trees:
        left = _host(t.left)[:t.n_nodes]
        node = np.arange(t.n_nodes)
        split = left >= 0
        if split.any():
            max_loff = max(max_loff, int((left[split] - node[split]).max()))
    return predict_record_bytes(n_feat=max(1, n_feat),
                                n_bins=max(1, n_bins), max_loff=max_loff)


# ---------------------------------------------------------------------------
# Pareto front
# ---------------------------------------------------------------------------

def pareto_front(metric, n_nodes, walk_bytes, configs) -> list:
    """Non-dominated set over (maximize metric, minimize n_nodes, minimize
    walk_bytes), metric-descending.

    ``configs`` is indexable in the raveled grids' flat order.  Exact
    duplicate (metric, nodes, bytes) triples keep the first config in grid
    order.  Sort by metric descending, then sweep a (nodes, bytes)
    staircase -- O(n log n)."""
    m = np.asarray(metric, dtype=np.float64).ravel()
    n = np.asarray(n_nodes, dtype=np.int64).ravel()
    b = np.asarray(walk_bytes, dtype=np.int64).ravel()
    order = np.lexsort((np.arange(m.size), b, n, -m))
    front: list[ParetoPoint] = []
    stair_n: list[int] = []      # accepted nodes, ascending
    stair_b: list[int] = []      # min bytes among accepted with nodes <= n
    seen = set()
    for i in order:
        key = (m[i], int(n[i]), int(b[i]))
        if key in seen:
            continue
        j = bisect.bisect_right(stair_n, int(n[i]))
        if j > 0 and stair_b[j - 1] <= int(b[i]):
            continue                                     # dominated
        seen.add(key)
        front.append(ParetoPoint(float(m[i]), int(n[i]), int(b[i]),
                                 dict(configs[i])))
        j = bisect.bisect_left(stair_n, int(n[i]))
        stair_n.insert(j, int(n[i]))
        prev = stair_b[j - 1] if j > 0 else np.iinfo(np.int64).max
        stair_b.insert(j, min(prev, int(b[i])))
        for k in range(j + 1, len(stair_b)):
            stair_b[k] = min(stair_b[k], stair_b[k - 1])
    return front


def _best_cell(metric, n_nodes, walk_bytes):
    """Flat index of the best cell: max metric, ties broken toward the
    cheapest config (fewest pruned nodes, then fewest predicted serve
    bytes, then first in grid order)."""
    m = np.asarray(metric)
    tie = m == m.max()
    big = np.iinfo(np.int64).max
    cost_n = np.where(tie, np.asarray(n_nodes, dtype=np.int64), big)
    cost_n_min = cost_n.min()
    cost_b = np.where(cost_n == cost_n_min,
                      np.asarray(walk_bytes, dtype=np.int64), big)
    return int(np.argmin(cost_b.ravel()))


# ---------------------------------------------------------------------------
# sweep: the public design-space API
# ---------------------------------------------------------------------------

def _resolve_axes(space: SweepSpace, full_depth: int, train_size: int):
    dv = (np.arange(1, full_depth + 1, dtype=np.int32)
          if space.dmax_values is None
          else np.asarray(space.dmax_values, dtype=np.int32))
    sv = (default_smin_values(train_size) if space.smin_values is None
          else np.asarray(space.smin_values, dtype=np.int32))
    wv = np.asarray(space.mcw_values, dtype=np.float32)
    if dv.size == 0 or sv.size == 0 or wv.size == 0:
        raise ValueError("every SweepSpace axis needs at least one value")
    return dv, sv, wv


def _axes_on(dev, sv, wv, dv):
    return tuple(tracing.to_device(a, None, dev) for a in (sv, wv, dv))


def _metric_grid_tree(tree, val_bins, y_val, n_num, dv, sv, wv,
                      classification, dev, mesh=None, dist=None,
                      num_steps=None):
    with tracing.span("toot.paths"):
        m = len(y_val)
        if mesh is None:
            lab, cnt, cmc = path_tables(tree, val_bins, n_num,
                                        num_steps=num_steps, device=dev)
            yv = tracing.to_device(np.asarray(y_val), torch.float32, dev)
            valid = torch.ones((m,), dtype=torch.bool, device=dev)
            totals = _grid_counts(lab, cnt, cmc, yv, valid,
                                  *_axes_on(dev, sv, wv, dv),
                                  classification=classification)
        else:
            from repro_torch.core.distributed import (DistConfig,
                                                      sharded_grid_counts)
            totals = sharded_grid_counts(
                mesh, dist if dist is not None else DistConfig(), tree,
                val_bins, y_val, n_num, sv, wv, dv,
                classification=classification, device=dev,
                num_steps=num_steps)
        totals = _host(totals)
        if classification:
            return totals.astype(np.float64) / m
        return -np.sqrt(totals.astype(np.float64) / m)


class _CellConfigs:
    """Lazy flat-index -> config-dict view over the grid axes (only the
    front's few survivors materialise their dict)."""

    def __init__(self, names, values, shape):
        self.names = names
        self.values = [np.asarray(v) for v in values]
        self.shape = shape

    def __getitem__(self, flat):
        idx = np.unravel_index(int(flat), self.shape)
        return {n: v[i].item()
                for n, v, i in zip(self.names, self.values, idx)}


def sweep(model, val_bins, y_val, n_num=None, *,
          space: SweepSpace | None = None, train_size: int | None = None,
          classification: bool = True, mesh=None, dist=None,
          device=None) -> SweepResult:
    """Price the full design space from one fitted model on ``device``
    (``None`` means CUDA): "fit once, price every config, return the
    front".

    ``model`` is a fitted ``Tree`` or ``GradientBoostedTrees``.  For a
    single tree every cell equals retraining with that cell's
    ``TreeConfig`` and evaluating on the validation set.  For an ensemble
    the ``n_rounds`` axis is exactly retraining; the pruning axes price
    predict-time pruning of every round's trees (the deployment semantics
    of serving the ensemble at those runtime hyper-parameters).

    ``mesh`` / ``dist`` (single trees only; every rank calls ``sweep``
    with the same arguments) shard the grid: validation rows over
    ``dist.data_axes``, the smin axis over ``dist.model_axis``, one int32
    psum and one all-gather (``core.distributed.sharded_grid_counts``);
    every rank returns the same result."""
    space = space or SweepSpace()
    dev = resolve_device(device)
    if isinstance(model, Tree):
        if n_num is None:
            raise ValueError("sweep(tree, ...) needs n_num (the per-feature "
                             "numeric-bin counts, e.g. table.n_num)")
        with tracing.span("toot.sweep"):
            return _sweep_tree(model, val_bins, y_val, n_num, space,
                               train_size, classification, dev, mesh, dist)
    if hasattr(model, "trees") and hasattr(model, "learning_rate"):
        if mesh is not None:
            raise ValueError("the mesh-sharded sweep path covers single "
                             "trees; price the ensemble per-device (the "
                             "n_rounds scan is already one pass)")
        return _sweep_ensemble(model, val_bins, y_val, n_num, space,
                               train_size, dev)
    raise TypeError(f"sweep() wants a Tree or GradientBoostedTrees, got "
                    f"{type(model).__name__}")


def _front_and_best(metric, nodes, wb, configs):
    front = pareto_front(metric, nodes, wb, configs)
    bi = _best_cell(metric, nodes, wb)
    best = ParetoPoint(float(metric.ravel()[bi]), int(nodes.ravel()[bi]),
                       int(wb.ravel()[bi]), dict(configs[bi]))
    return front, best


def _sweep_tree(tree, val_bins, y_val, n_num, space, train_size,
                classification, dev, mesh=None, dist=None):
    n_train = (train_size if train_size is not None
               else int(tracing.read_scalar(tree.count[0])))
    full_depth = max(1, tree.max_tree_depth)
    dv, sv, wv = _resolve_axes(space, full_depth, n_train)
    metric = _metric_grid_tree(tree, val_bins, y_val, n_num, dv, sv, wv,
                               classification, dev, mesh, dist, full_depth)
    with tracing.span("toot.cost"):
        nodes, pdepth = _cost_grids(tree, dv, sv, wv)
        wb = walk_bytes_per_request(1, pdepth,
                                    _predicted_record_bytes([tree]))
    configs = _CellConfigs(
        ("max_depth", "min_samples_split", "min_child_weight"),
        (dv, sv, wv), metric.shape)
    with tracing.span("toot.front"):
        front, best = _front_and_best(metric, nodes, wb, configs)
    return SweepResult(dmax=dv, smin=sv, mcw=wv, n_rounds=None,
                       metric=metric, n_nodes=nodes, walk_bytes=wb,
                       front=front, best=best, n_configs=metric.size)


def _sweep_ensemble(ens, val_bins, y_val, n_num, space, train_size, dev):
    lo = ens._fitted_loss()
    if getattr(lo, "n_classes", 0):
        raise NotImplementedError("sweep() prices scalar-loss ensembles; "
                                  "multiclass softmax rounds stack C trees "
                                  "per round (open item)")
    logistic = lo.link_id == 1
    trees = ens.trees
    r_total = len(trees)
    if n_num is None:
        n_num = ens.n_num
    n_train = (train_size if train_size is not None
               else int(round(float(
                   tracing.read_scalar(trees[0].count[0])))))
    full_depth = max(max(1, t.max_tree_depth) for t in trees)
    dv, sv, wv = _resolve_axes(space, full_depth, n_train)
    rv = (np.arange(1, r_total + 1, dtype=np.int32)
          if space.n_rounds_values is None
          else np.asarray(space.n_rounds_values, dtype=np.int32))
    if rv.size == 0 or rv.min() < 1 or rv.max() > r_total:
        raise ValueError(f"n_rounds_values must lie in 1..{r_total}")

    bins = torch.as_tensor(val_bins, dtype=torch.int32, device=dev)
    tables = [path_tables(t, bins, n_num, num_steps=full_depth, device=dev)
              for t in trees]
    m = bins.shape[0]
    yv = torch.as_tensor(np.asarray(y_val), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    totals = _ensemble_grid_counts(
        tables, yv, torch.ones((m,), dtype=torch.bool, device=dev),
        *_axes_on(dev, sv, wv, dv), torch.tensor(ens.learning_rate, **f32),
        torch.tensor(ens.base, **f32), logistic=logistic)
    totals = _host(totals)[rv - 1]                     # [R,Nd,Ns,Nw]
    if logistic:
        metric = totals.astype(np.float64) / m
    else:
        metric = -np.sqrt(totals.astype(np.float64) / m)

    # cost: per-round cost grids, prefix-summed (count) / prefix-maxed
    # (depth -> serve walk steps) over rounds
    per_round = [_cost_grids(t, dv, sv, wv) for t in trees]
    nodes_prefix = np.cumsum(np.stack([n for n, _ in per_round]), axis=0)
    steps_prefix = np.maximum.accumulate(
        np.stack([d for _, d in per_round]), axis=0)
    nodes = nodes_prefix[rv - 1]
    wb = walk_bytes_per_request(rv[:, None, None, None],
                                steps_prefix[rv - 1],
                                _predicted_record_bytes(trees))
    configs = _CellConfigs(
        ("n_rounds", "max_depth", "min_samples_split", "min_child_weight"),
        (rv, dv, sv, wv), metric.shape)
    front, best = _front_and_best(metric, nodes, wb, configs)
    return SweepResult(dmax=dv, smin=sv, mcw=wv, n_rounds=rv,
                       metric=metric, n_nodes=nodes, walk_bytes=wb,
                       front=front, best=best, n_configs=metric.size)


# ---------------------------------------------------------------------------
# the 2-axis surface: a view over the 3-axis grid
# ---------------------------------------------------------------------------

def toot_grid(tree: Tree, val_bins, y_val, n_num, *, dmax_values=None,
              smin_values=None, train_size: int | None = None,
              classification: bool = True, device=None) -> ToolGrid:
    """Score the (max_depth x min_samples_split) grid with one path pass."""
    n = (train_size if train_size is not None
         else int(tracing.read_scalar(tree.count[0])))
    space = SweepSpace(
        dmax_values=None if dmax_values is None else tuple(
            np.asarray(dmax_values).tolist()),
        smin_values=None if smin_values is None else tuple(
            np.asarray(smin_values).tolist()))
    dv, sv, wv = _resolve_axes(space, max(1, tree.max_tree_depth), n)
    metric = _metric_grid_tree(tree, val_bins, y_val, n_num, dv, sv, wv,
                               classification, resolve_device(device))
    return ToolGrid(np.asarray(dv), np.asarray(sv), metric[:, :, 0])


def tune(tree: Tree, val_bins, y_val, n_num, *, train_size=None,
         classification=True, dmax_values=None, smin_values=None,
         device=None) -> TuneResult:
    """Pick the best (max_depth, min_samples_split) cell; flat metric ties
    go to the cheapest config (smallest pruned node count, then first in
    grid order)."""
    grid = toot_grid(tree, val_bins, y_val, n_num, train_size=train_size,
                     classification=classification, dmax_values=dmax_values,
                     smin_values=smin_values, device=device)
    nodes, _ = _cost_grids(tree, grid.dmax, grid.smin, np.zeros(1))
    nodes2 = nodes[:, :, 0]
    tie = grid.metric == grid.metric.max()
    cost = np.where(tie, nodes2, np.iinfo(np.int64).max)
    i, j = np.unravel_index(int(np.argmin(cost)), grid.metric.shape)
    return TuneResult(int(grid.dmax[i]), int(grid.smin[j]),
                      float(grid.metric[i, j]), grid,
                      n_configs=grid.metric.size,
                      best_nodes=int(nodes2[i, j]))


def prune_stats(tree: Tree, dmax: int, smin: int, mcw: float = 0.0):
    """Node count / depth of the pruned tree (reachable under the tuned
    hyper-parameters), by a host-side walk -- the oracle ``_cost_grids``
    must match cell for cell."""
    left, right = _host(tree.left), _host(tree.right)
    leaf, count, depth = _host(tree.leaf), _host(tree.count), _host(tree.depth)
    n, max_d, stack = 0, 0, [0]
    while stack:
        u = stack.pop()
        n += 1
        max_d = max(max_d, int(depth[u]))
        stops = (leaf[u] or left[u] < 0 or count[u] < smin
                 or depth[u] >= dmax
                 or (mcw > 0
                     and min(count[left[u]], count[right[u]]) <= mcw))
        if not stops:
            stack.append(int(left[u]))
            stack.append(int(right[u]))
    return n, max_d
