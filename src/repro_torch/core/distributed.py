"""Distributed UDT build over a ``torch.distributed`` mesh.

Counterpart of ``repro.core.distributed``'s sharded build.  The reference
runs one ``shard_map`` body over a JAX mesh; here every rank is one process
(``torch.distributed``, NCCL on the card, gloo on the CPU) that holds only
its own shard, runs the port's level step on it (``core.tree``'s
``_chunk_step`` / ``_chunk_step_classes`` / ``_route_step`` with the
sharded arguments) and meets the others in the collectives of
``core.collectives``:

  * **data parallel** over ``DistConfig.data_axes``: each rank holds a block
    of example rows and builds local ``H[S, K_l, B, C]`` histograms; one
    psum per level chunk merges them (``S*K_l*B*C*4`` bytes, independent of
    M).  With ``slot_scatter`` the chunk is reduce-scattered over slots
    instead and the per-slot decisions are all-gathered afterwards; with
    sibling subtraction as well, the packed ``[S/2]`` smaller-child block
    is what is reduce-scattered, and each rank derives the co-children of
    its own pairs.
  * **feature parallel** over ``DistConfig.model_axis``: each rank selects
    on its own features; one all-gather of per-slot candidate tuples picks
    the global winner, and routing psums one int32 bit per row.

The tree arrays are replicated: every rank makes the same writes from the
same gathered values, so every rank returns the same tree.  Integer class
counts make the classification tree equal the local ``build_tree``'s bit
for bit in any reduction order; float moment channels agree to the
reference's tolerance.

Where the reference lets XLA move the cached parent level between levels
(a gather on a slot-sharded array), the port does it by hand: a rank that
kept only its block of a scattered level gets each pair's parent row from
the rank holding it, in one ``all_to_all`` over the data axes, counted
under the tag ``parent``.

Set-up is the caller's: ``torch.distributed.init_process_group`` with an
explicit address, world size and rank, then a ``DeviceMesh`` with named
dims, e.g. ``init_device_mesh("cuda", (d, f), mesh_dim_names=("data",
"model"))``.  Not ported yet: the sharded boosting loop (the GOSS sampler,
the ensemble walk, the grid counts and the ensembles' ``mesh=``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.binning import BinnedTable
from repro_torch.core.collectives import Collectives
from repro_torch.core.tree import (TREE_FIELDS, Tree, TreeConfig,
                                   _auto_chunk_slots, _check_backends,
                                   _chunk_step, _chunk_step_classes, _grow,
                                   _grow_batched, _init_arrays, _prepare,
                                   _route_step, _subtract_eligible)

__all__ = ["DistConfig", "DistributedBuilder", "build_tree_distributed",
           "make_sharded_step", "make_sharded_route", "scatter_ok"]


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Mesh layout of the distributed build.

    ``data_axes`` names the mesh dims the examples are sharded over (rows of
    the [M, K] binned table, targets, weights, assignments); ``model_axis``
    names the feature-sharding dim, or ``None`` for data parallel only.  The
    names must be dims of the mesh; an empty ``data_axes`` / a ``None``
    ``model_axis`` means no collective on that side."""
    data_axes: tuple = ("data",)       # example-sharding mesh dims
    model_axis: str | None = "model"   # feature-sharding mesh dim (or None)
    # Two COMPOSABLE ways to shrink the per-level histogram collective:
    #   slot_scatter  -- reduce-scatter the histogram chunk over its leading
    #                    axis (1/dsize of the selection work per rank);
    #   sibling subtraction (TreeConfig.sibling_subtraction) -- reduce only
    #    the packed smaller-child histogram ([S/2,K,B,C]).
    # With both on, the packed [S/2] pair axis is reduce-scattered and each
    # rank derives its co-child slots from its pairs' parent rows.  A chunk
    # whose pair count does not divide the data-shard count falls back to
    # the psum + subtraction path (still exact).
    slot_scatter: bool = True


def _pad_to(x, mult, axis, fill):
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def scatter_ok(dist: DistConfig, d_shards: int, num_slots: int,
               use_sub: bool) -> bool:
    """Whether a chunk of ``num_slots`` reduce-scatters: its leading axis
    (the slots, or the packed pairs under subtraction) must split over the
    data shards."""
    return (dist.slot_scatter and num_slots % d_shards == 0
            and (not use_sub or (num_slots // 2) % d_shards == 0))


def make_sharded_step(comm: Collectives, dist: DistConfig, kw: dict,
                      num_slots: int, use_sub: bool = False,
                      want_hist: bool = False, classes: int = 0):
    """The level-chunk step of one rank for a slot count: ``core.tree``'s
    ``_chunk_step`` (``classes`` > 0: ``_chunk_step_classes``) with the
    mesh's collectives bound in and ``slot_scatter`` decided by
    ``scatter_ok``."""
    inner = _chunk_step_classes if classes else _chunk_step
    return functools.partial(
        inner, **kw, num_slots=num_slots, use_sub=use_sub,
        want_hist=want_hist, comm=comm, data_axes=tuple(dist.data_axes),
        model_axis=dist.model_axis,
        slot_scatter=scatter_ok(dist, comm.shards(dist.data_axes), num_slots,
                                use_sub))


def make_sharded_route(comm: Collectives, dist: DistConfig):
    """The level router of one rank (one tree or a class axis of them):
    ``_route_step`` with the feature-parallel predicate."""
    return functools.partial(_route_step, comm=comm,
                             model_axis=dist.model_axis)


def _parent_rows(comm, dist, d_shards, parent, cache, cs, s, prev):
    """Each sibling pair's parent histogram row for one level chunk on this
    rank: ``core.tree._grow``'s ``parent_rows``, over a class axis too.

    ``prev`` is the (chunk width, use_sub) of the level that filled
    ``cache``.  A level whose chunks were not reduce-scattered is whole on
    every rank: a local gather.  One that was is cached as this rank's
    blocks only (chunk c's rows ``[idx * per, (idx + 1) * per)`` of its
    slots, concatenated), so each row lives on one rank, which sends it to
    the ranks that need it in one ``all_to_all`` over the data axes.  When
    this chunk's pairs are scattered too, only the rank holding a pair
    needs its row: the ranks send S/2 rows between them, not S/2 each.
    Pairs past the chunk's valid region read zeros (no consumer reads
    them)."""
    base, hist = cache
    dev = parent.device
    lead = parent.shape[:-1]                      # () or (C,)
    n = parent.shape[-1]
    if lead:          # [C] host cursors (a copy, as the local build's)
        cs = torch.as_tensor(cs, device=dev)[:, None]
        base = torch.as_tensor(base, device=dev)[:, None]
    ids = torch.arange(0, s, 2, device=dev) + cs
    pid = torch.where(ids < n, parent.gather(-1, ids.clamp(max=n - 1)), -1)
    lanes = lead[0] if lead else 1
    g = (pid.long() - base).reshape(lanes, -1)    # [lanes, pairs]
    lane = torch.arange(lanes, device=dev)[:, None].expand_as(g)
    n_pairs, rows, tail = g.shape[1], hist.shape[len(lead)], hist.shape[-3:]

    def take(lane_, row):
        return hist[lane_, row] if lead else hist[row]

    axes = tuple(dist.data_axes)
    me = comm.data_index(axes)
    pair_scatter = scatter_ok(dist, d_shards, s, True)
    per2 = n_pairs // d_shards if pair_scatter else n_pairs
    lo = me * per2 if pair_scatter else 0          # this rank's first pair
    if not (axes and scatter_ok(dist, d_shards, *prev)):
        mine = slice(lo, lo + per2)
        return take(lane[:, mine], g.clamp(0, rows - 1)[:, mine]).reshape(
            *lead, per2, *tail)
    per = prev[0] // d_shards
    gc = g.clamp(min=0)
    within = gc % prev[0]
    j = (gc // prev[0]) * per + within % per      # the row in its owner's cache
    owner = torch.where((g >= 0) & (j < rows), within // per, -1).reshape(-1)
    j, lane = j.clamp(max=rows - 1).reshape(-1), lane.reshape(-1)
    pair = torch.arange(n_pairs, device=dev).repeat(lanes)    # lane-major
    ranks = torch.arange(d_shards, device=dev)[:, None]
    needs = ((pair // per2 == ranks) if pair_scatter
             else torch.ones_like(ranks + pair, dtype=torch.bool))
    send = needs & (owner == me)                  # [rank, item], by rank
    recv = needs[me] & (owner == ranks)           # [rank, item], by source
    counts = torch.stack([send.sum(1), recv.sum(1)]).tolist()
    item = send.nonzero()[:, 1]
    got = comm.all_to_all(take(lane[item], j[item]), counts[0], counts[1],
                          axes, "parent")
    item = recv.nonzero()[:, 1]
    out = hist.new_zeros((lanes * per2, *tail))
    out[(item // n_pairs) * per2 + item % n_pairs - lo] = got
    return out.reshape(*lead, per2, *tail)


class DistributedBuilder:
    """Stage a BinnedTable on this rank once; build many trees from it.

    Every rank is handed the whole host table and keeps its block: the rows
    at its flattened data-shard index (mesh-major over ``dist.data_axes``,
    padded to a multiple of the data-shard count with inert rows, assign
    -1) and the features at its model coordinate (padded with all-bin-0
    columns with ``n_num = n_cat = 0``, never selectable).  ``device=None``
    means CUDA; the mesh's device type must be the device's.
    ``self.comm.counts`` counts the collectives of every build, and
    ``self.chunks`` lists the (num_slots, use_sub) of their chunk steps in
    order."""

    def __init__(self, table: BinnedTable, config: TreeConfig = TreeConfig(),
                 *, mesh, dist: DistConfig = DistConfig(),
                 n_classes: int | None = None, device=None):
        _check_backends(config)
        self.device = dev = resolve_device(device)
        if mesh.device_type != dev.type:
            raise ValueError(f"the mesh is on {mesh.device_type!r}, the "
                             f"build on {dev.type!r}")
        self.comm = comm = Collectives(mesh)
        self.chunks: list = []
        self.table, self.config, self.dist = table, config, dist
        m, k = table.bins.shape
        self.m, self.k, self.b = int(m), int(k), int(table.n_bins)
        self.d_shards = comm.shards(dist.data_axes)
        if dist.data_axes:
            comm.group(dist.data_axes)    # every rank, now: see its docstring
        self.f_shards = comm.shards(
            () if dist.model_axis is None else (dist.model_axis,))

        if config.task == "classification":
            if n_classes is None:
                raise ValueError("DistributedBuilder needs n_classes for "
                                 "classification (build_tree_distributed "
                                 "infers it from y)")
            self.c = int(n_classes)
        elif config.task == "regression_variance":
            self.c = 3
        else:
            self.c = 2
        self.n_classes = n_classes

        self.m_pad = self.m + (-self.m) % self.d_shards
        self.k_pad = self.k + (-self.k) % self.f_shards
        m_loc, k_loc = self.m_pad // self.d_shards, self.k_pad // self.f_shards
        r0 = comm.data_index(dist.data_axes) * m_loc
        f0 = (0 if dist.model_axis is None
              else comm.axis_index(dist.model_axis) * k_loc)
        self._rows = slice(r0, r0 + m_loc)
        bins = _pad_to(_pad_to(np.asarray(table.bins), self.d_shards, 0, 0),
                       self.f_shards, 1, 0)
        self.bins = self._put(bins[self._rows, f0:f0 + k_loc], torch.int32)
        self.n_num, self.n_cat = (
            self._put(_pad_to(np.asarray(v), self.f_shards, 0, 0)
                      [f0:f0 + k_loc], torch.int32)
            for v in (table.n_num, table.n_cat))

        self.max_nodes = config.max_nodes or min(2 * self.m + 1, 1 << 22)
        self.s_cap = config.chunk_slots or _auto_chunk_slots(
            self.k_pad, self.b, self.c, config.hist_budget_bytes)
        assign0 = np.full((self.m_pad,), -1, dtype=np.int32)
        assign0[:self.m] = 0            # padding rows never join any node
        self._assign0 = self._stage_rows(assign0, -1, torch.int32)
        self._route = make_sharded_route(comm, dist)

    def _put(self, x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=self.device).contiguous()

    def _stage_rows(self, x, fill, dtype):
        """This rank's block of a per-example array whose LAST axis is the
        rows: ``[m]`` (or class-first ``[C, m]``), host or tensor, padded
        to ``m_pad`` with ``fill``; an array already ``m_pad`` long is only
        sliced."""
        x = torch.as_tensor(x)
        if x.shape[-1] == self.m:
            x = torch.nn.functional.pad(x, (0, self.m_pad - self.m),
                                        value=fill)
        if x.shape[-1] != self.m_pad:
            raise ValueError(f"rows: last axis {x.shape[-1]}, expected "
                             f"{self.m} (or padded {self.m_pad})")
        return x[..., self._rows].to(device=self.device,
                                     dtype=dtype).contiguous()

    def _subtract(self, c, weighted):
        # the cache-budget gate uses this rank's feature-block row bytes
        if not _subtract_eligible(self.config, self.m, weighted):
            return None
        return ((self.k_pad // self.f_shards) * self.b * c * 4,
                self.config.sub_cache_bytes)

    def _grow_kw(self):
        return dict(max_depth=self.config.max_depth,
                    parent_rows=functools.partial(
                        _parent_rows, self.comm, self.dist, self.d_shards))

    def build(self, y, sample_weight=None, assign=None,
              level_callback=None) -> Tree:
        """Build one tree (every rank returns the same tree).  ``y`` /
        ``sample_weight`` / ``assign`` are host arrays or tensors over all
        ``m`` rows (or ``m_pad``); ``assign`` defaults to every valid row at
        the root, and a caller's assignment must keep padding rows at -1.
        On a scattered level, a ``level_callback`` state's ``phist`` holds
        only this rank's blocks of the cached slots."""
        config, dist = self.config, self.dist
        weighted = sample_weight is not None
        if weighted and config.task == "regression":
            raise ValueError("sample_weight is unsupported for the "
                             "label-split 'regression' task (use "
                             "'regression_variance')")
        if config.task == "regression_variance":
            yv = self._stage_rows(y, 0.0, torch.float32)
            stats = torch.zeros((yv.shape[0], 3), device=self.device)
            lbins = torch.zeros_like(yv, dtype=torch.int32)
            c, n_label_bins = 3, 1
        else:
            _, stats_h, lbins_h, yv_h, c, n_label_bins = _prepare(
                self.table, np.asarray(y), config, self.n_classes)
            stats = self._stage_rows(np.asarray(stats_h).T, 0.0,
                                     torch.float32).T.contiguous()
            lbins = self._stage_rows(lbins_h, 0, torch.int32)
            yv = self._stage_rows(yv_h, 0.0, torch.float32)
        w = (self._stage_rows(sample_weight, 0.0, torch.float32)
             if weighted else None)
        assign = (self._assign0.clone() if assign is None
                  else self._stage_rows(assign, -1, torch.int32))

        kw = dict(n_bins=self.b, heuristic=config.heuristic, task=config.task,
                  min_samples_split=config.min_samples_split,
                  min_samples_leaf=config.min_samples_leaf,
                  max_depth=config.max_depth, max_nodes=self.max_nodes,
                  hist_backend=config.hist_backend,
                  select_backend=config.select_backend,
                  n_label_bins=n_label_bins, weighted=weighted,
                  min_child_weight=config.min_child_weight)

        def step(arrays, assign_, cs, cn, next_free, depth, num_slots, pp,
                 use_sub, want_hist):
            self.chunks.append((num_slots, use_sub))
            fn = make_sharded_step(self.comm, dist, kw, num_slots, use_sub,
                                   want_hist)
            return fn(self.bins, stats, lbins, yv, assign_, arrays, pp,
                      self.n_num, self.n_cat, cs, cn, next_free, depth, w)

        def route(assign_, arrays, start, end):
            return self._route(self.bins, assign_, arrays, self.n_num, start,
                               end)

        arrays = _init_arrays(self.max_nodes + 1, self.device)  # + drop slot
        arrays, n_nodes = _grow(step, route, arrays, assign, self.s_cap,
                                self.max_nodes, level_callback,
                                subtract=self._subtract(c, weighted),
                                **self._grow_kw())
        return Tree(n_nodes=n_nodes,
                    **{f: arrays[f][:self.max_nodes] for f in TREE_FIELDS})

    def build_batched(self, z, sample_weight=None, assign=None,
                      level_callback=None):
        """Build one ``regression_variance`` tree per row of ``z`` [C, m]
        through one sharded class-stacked build: the mesh twin of
        ``core.tree.build_trees_batched``, with the same returns (per-class
        ``Tree`` views and the stacked ``[C, max_nodes]`` arrays).
        ``sample_weight`` is [C, m]; ``assign`` [C, m] or [m]."""
        config, dist = self.config, self.dist
        if config.task != "regression_variance":
            raise ValueError("build_batched fits 'regression_variance' "
                             "trees (the boosting round task); got task="
                             f"{config.task!r}")
        weighted = sample_weight is not None
        z = self._stage_rows(z, 0.0, torch.float32)
        n_stack = z.shape[0]
        w = (self._stage_rows(sample_weight, 0.0, torch.float32)
             if weighted else None)
        assign = (self._assign0 if assign is None
                  else self._stage_rows(assign, -1, torch.int32))
        assign = assign.expand(n_stack, -1).clone()

        kw = dict(n_bins=self.b, min_samples_split=config.min_samples_split,
                  min_samples_leaf=config.min_samples_leaf,
                  max_depth=config.max_depth, max_nodes=self.max_nodes,
                  hist_backend=config.hist_backend,
                  select_backend=config.select_backend,
                  min_child_weight=config.min_child_weight)
        dev = self.device

        def step(arrays, assign_, cs, cn, next_free, depth, num_slots, pp,
                 use_sub, want_hist):
            self.chunks.append((num_slots, use_sub))
            fn = make_sharded_step(self.comm, dist, kw, num_slots, use_sub,
                                   want_hist, classes=n_stack)
            cur = torch.as_tensor(np.stack([cs, cn, next_free]),
                                  dtype=torch.int32).to(dev)
            return fn(self.bins, z, assign_, arrays, pp, self.n_num,
                      self.n_cat, cur[0], cur[1], cur[2], depth, w)

        def route(assign_, arrays, start, end):
            cur = torch.as_tensor(np.stack([start, end]),
                                  dtype=torch.int32).to(dev)
            return self._route(self.bins, assign_, arrays, self.n_num,
                               cur[0][:, None], cur[1][:, None])

        arrays = {k_: v[None].repeat(n_stack, 1)                # + drop slot
                  for k_, v in _init_arrays(self.max_nodes + 1, dev).items()}
        arrays, n_nodes = _grow_batched(step, route, arrays, assign,
                                        self.s_cap, self.max_nodes,
                                        level_callback, n_stack,
                                        subtract=self._subtract(3, weighted),
                                        **self._grow_kw())
        arrays = {f: arrays[f][:, :self.max_nodes] for f in TREE_FIELDS}
        trees = [Tree(n_nodes=int(n_nodes[c]),
                      **{f: arrays[f][c] for f in TREE_FIELDS})
                 for c in range(n_stack)]
        return trees, arrays


def build_tree_distributed(table: BinnedTable, y,
                           config: TreeConfig = TreeConfig(), mesh=None,
                           dist: DistConfig = DistConfig(),
                           n_classes: int | None = None,
                           level_callback=None, sample_weight=None,
                           device=None) -> Tree:
    """Distributed UDT training on ``mesh`` (a ``DeviceMesh`` with named
    dims; every rank calls this with the same arguments).  Gives the tree
    ``build_tree`` gives, bit for bit for classification with the
    ``"torch"`` selection rule (see ``core.tree._pick_global`` for the
    ``"kernel"`` rule across feature shards).  One-shot wrapper around
    ``DistributedBuilder``."""
    if mesh is None:
        raise ValueError("build_tree_distributed needs a DeviceMesh")
    if config.task == "classification" and n_classes is None:
        n_classes = int(np.asarray(y).max()) + 1
    builder = DistributedBuilder(table, config, mesh=mesh, dist=dist,
                                 n_classes=n_classes, device=device)
    return builder.build(y, sample_weight=sample_weight,
                         level_callback=level_callback)
