"""Distributed UDT build over a ``torch.distributed`` mesh.

Counterpart of ``repro.core.distributed``'s sharded build.  The reference
runs one ``shard_map`` body over a JAX mesh; here every rank is one process
(``torch.distributed``, NCCL on the card, gloo on the CPU) that holds only
its own shard, runs the local build's one level loop on it (``core.tree``'s
``_grow`` over one tree or a class axis of them, its chunk steps
``_chunk_step`` / ``_chunk_step_classes`` and ``_route_step`` given the
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
"model"))``.

The sharded boosting loop (``GradientBoostedTrees.fit(mesh=...)``) adds
three per-rank pieces around the builder: ``make_sharded_sampler`` (the
GOSS draw on the rank's rows, one scalar pmax per data axis, tag
``goss``), ``make_sharded_walk`` (the score update through the
feature-parallel predicate, tag ``walk``) and ``sharded_grid_counts``
(the TOOT grid of ``sweep(tree, ..., mesh=)``, tag ``grid``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.binning import BinnedTable
from repro_torch.core.collectives import Collectives
from repro_torch.core.tree import (Tree, TreeConfig, _auto_chunk_slots,
                                   _check_backends, _chunk_step,
                                   _chunk_step_classes, _closures, _grow,
                                   _lane_arrays, _node_predicate, _operands,
                                   _pair_parents, _route_step, _step_kw,
                                   _subtract_eligible, _tree_views)
from repro_torch.core.tree import _parent_rows as _local_parent_rows

__all__ = ["DistConfig", "DistributedBuilder", "build_tree_distributed",
           "make_sharded_step", "make_sharded_route", "make_sharded_sampler",
           "make_sharded_walk", "sharded_grid_counts", "scatter_ok"]


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


def make_sharded_sampler(comm: Collectives, dist: DistConfig, loss, goss,
                         m: int, q_top: int, q_oth: int,
                         weighted: bool = False):
    """One round's sampling step of the sharded boosting loop on this rank:
    ``fn(y, raw, round_seed, sw=None) -> (z, w, assign0)`` over the rank's
    ``[m_loc]`` rows (``raw`` and the outputs class-first ``[C, m_loc]``
    for a multiclass loss): the Newton target ``z``, the build weight
    ``w`` (GOSS amplification x hessian, 0 drops the row) and the root
    assignment (0 selected, -1 inert).  With ``goss`` None every valid row
    is selected at its hessian weight.  ``weighted`` means an ``sw`` block
    scales g and h after ``z`` is formed, as in the local loop.

    The draw is the per-shard-quota scheme of ``core.forest``'s stage
    functions on this rank's block (softmax: one draw ranked by
    ``sqrt(sum_c g_c^2 h_c)``, each class's hessians on the shared
    weights).  Its only collective is one scalar pmax per data axis (tag
    ``goss``): no row leaves its shard, and nothing syncs with the host.
    The uniforms come from ``forest._shard_uniforms(round_seed, shard)``
    with the rank's mesh-major data-shard index."""
    from repro_torch.core import forest
    axes = tuple(dist.data_axes)
    shard = comm.data_index(axes)
    multiclass = getattr(loss, "is_multiclass", False)
    keep_h = weighted or not loss.constant_hessian

    def sample(y, raw, round_seed, sw=None):
        g, h = loss.grad_hess(y, raw)
        z = loss.newton_target(g, h)
        if sw is not None:
            g, h = g * sw, h * sw          # the trailing axis is the rows
        m_loc = y.shape[0]
        rows = shard * m_loc + torch.arange(m_loc, device=y.device)
        valid = rows < m
        if goss is None:
            w = torch.where(valid, h, 0.0)
            assign0 = torch.where(valid, 0, -1).to(torch.int32)
            return z, w, assign0.expand_as(z).contiguous()
        if multiclass:
            rank = torch.sqrt(torch.sum(g * g * h, dim=0))
        else:
            rank = g * torch.sqrt(h) if keep_h else g
        lv = torch.where(valid, rank.abs(), -1.0)
        u = torch.where(valid, forest._shard_uniforms(round_seed, shard,
                                                      m_loc, y.device), -1.0)
        tau = comm.pmax(forest._goss_shard_boundary(lv, q_top), axes, "goss")
        w_goss = forest._goss_shard_weights(lv, u, tau, q_top, q_oth)
        assign0 = torch.where(w_goss > 0, 0, -1).to(torch.int32)
        if multiclass:
            return z, w_goss[None] * h, assign0.expand_as(z).contiguous()
        return z, (w_goss * h if keep_h else w_goss), assign0

    return sample


def make_sharded_walk(comm: Collectives, dist: DistConfig, num_steps: int):
    """The sharded raw-score update of this rank: ``fn(raw, arrays, bins,
    n_num, lr)`` is ``raw + lr * label[leaf]``, the leaf reached by walking
    the rank's (data, model) block of bins for ``num_steps`` steps with no
    runtime limits (``predict._walk``'s descent).  Each step's predicate is
    the level router's feature-parallel one (one int32 psum per step over
    the model axis, tag ``walk``; none without a model axis), so the scores
    never leave their data shard.  One tree (``raw [m_loc]``, ``[N]``
    arrays) or a round's class-trees (``raw [C, m_loc]``, ``[C, N]``)."""
    def walk(raw, arrays, bins, n_num, lr):
        node = torch.zeros(raw.shape, dtype=torch.long, device=raw.device)

        def at(name):
            return arrays[name].gather(-1, node)

        for _ in range(num_steps):
            left = at("left")
            can = ~at("leaf") & (left >= 0)
            pos = _node_predicate(bins, at("feat"), at("op"), at("tbin"),
                                  n_num, comm, dist.model_axis, "walk")
            node = torch.where(can, torch.where(pos, left, at("right")).long(),
                               node)
        return raw + lr * at("label")

    return walk


def sharded_grid_counts(mesh, dist: DistConfig, tree: Tree, val_bins, y_val,
                        n_num, smin, mcw, dmax, *, classification: bool = True,
                        device=None, comm: Collectives | None = None,
                        num_steps: int | None = None) -> torch.Tensor:
    """The TOOT grid of ``tree`` on ``mesh``: the ``[Nd, Ns, Nw]`` totals of
    ``core.tuning._grid_counts`` over the whole validation set, on every
    rank.  The validation rows are split over the data axes (padded with
    rows that ``valid`` keeps inert) and each rank walks only its block's
    paths; the smin axis is split over the model axis (padded with int32
    max, trimmed afterwards).  One psum over the data axes adds the int32
    counts (f32 sums for regression), one all-gather over the model axis
    joins the smin blocks (both tag ``grid``), counted on ``comm`` when
    one is given.  ``num_steps`` is the path walk's length (``None``: the
    tree's depth, one host read of a card tree).  The validation set and
    the axes may be host arrays or tensors already on the device, which
    are not copied."""
    from repro_torch.core.tuning import _grid_counts, path_tables
    dev = resolve_device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the sweep "
                         f"on {dev.type!r}")
    comm = Collectives(mesh) if comm is None else comm
    axes = tuple(dist.data_axes)
    d_shards = comm.shards(axes)
    model = () if dist.model_axis is None else (dist.model_axis,)
    f_shards = comm.shards(model)
    m = len(y_val)
    m_loc = -(-m // d_shards)
    r0 = comm.data_index(axes) * m_loc
    rows = slice(r0, min(r0 + m_loc, m))
    pad = m_loc - (rows.stop - rows.start)
    vb = torch.as_tensor(val_bins, dtype=torch.int32)[rows]
    lab, cnt, cmc = path_tables(
        tree, torch.nn.functional.pad(vb, (0, 0, 0, pad)), n_num,
        num_steps=num_steps, device=dev)
    y = torch.nn.functional.pad(torch.as_tensor(
        y_val, dtype=torch.float32)[rows].to(dev), (0, pad))
    valid = torch.arange(r0, r0 + m_loc, device=dev) < m
    smin = torch.as_tensor(smin, dtype=torch.int32)
    ns = smin.shape[0]
    smin = torch.cat([smin, smin.new_full(((-ns) % f_shards,),
                                          np.iinfo(np.int32).max)])
    s_loc = smin.shape[0] // f_shards
    s0 = comm.data_index(model) * s_loc
    out = _grid_counts(lab, cnt, cmc, y, valid,
                       smin[s0:s0 + s_loc].to(dev),
                       torch.as_tensor(mcw, dtype=torch.float32).to(dev),
                       torch.as_tensor(dmax, dtype=torch.int32).to(dev),
                       classification=classification)
    out = comm.psum(out, axes, "grid")
    return comm.all_gather(out, model, "grid", dim=1)[:, :ns]


def _parent_rows(comm, dist, d_shards, parent, cache, cs, s, prev):
    """Each sibling pair's parent histogram row for one level chunk on this
    rank: ``core.tree._parent_rows`` (one tree or a class axis), and what
    the mesh adds.

    ``prev`` is the (chunk width, use_sub) of the level that filled
    ``cache``.  A level whose chunks were not reduce-scattered is whole on
    every rank: the local gather.  One that was is cached as this rank's
    blocks only (chunk c's rows ``[idx * per, (idx + 1) * per)`` of its
    slots, concatenated), so each row lives on one rank, which sends it to
    the ranks that need it in one ``all_to_all`` over the data axes.  When
    this chunk's pairs are scattered too, only the rank holding a pair
    needs its row: the ranks send S/2 rows between them, not S/2 each.
    Pairs past the chunk's valid region read zeros (no consumer reads
    them)."""
    axes = tuple(dist.data_axes)
    me = comm.data_index(axes)
    pair_scatter = scatter_ok(dist, d_shards, s, True)
    n_pairs = s // 2
    per2 = n_pairs // d_shards if pair_scatter else n_pairs
    lo = me * per2 if pair_scatter else 0          # this rank's first pair
    if not (axes and scatter_ok(dist, d_shards, *prev)):
        return _local_parent_rows(parent, cache, cs, s)[
            ..., lo:lo + per2, :, :, :]
    base, hist = cache
    dev = parent.device
    lead = parent.shape[:-1]                      # () or (C,)
    lanes = lead[0] if lead else 1
    g = _pair_parents(parent, base, cs, s).reshape(lanes, n_pairs)
    lane = torch.arange(lanes, device=dev)[:, None].expand_as(g)
    rows, tail = hist.shape[len(lead)], hist.shape[-3:]

    def take(lane_, row):
        return hist[lane_, row] if lead else hist[row]

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

    Every rank is handed the whole table (host or tensor) and keeps its
    block: the rows
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
        # only this rank's block is copied (the table may be host numpy or
        # a tensor, e.g. a forest's bootstrap gathered on the card); rows
        # and features past the table are padding, all bin 0
        bins = torch.as_tensor(table.bins)[self._rows, f0:f0 + k_loc]
        self.bins = torch.nn.functional.pad(
            bins, (0, k_loc - bins.shape[1], 0, m_loc - bins.shape[0])).to(
            device=dev, dtype=torch.int32).contiguous()
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

    def _moment_task(self, what):
        if self.config.task != "regression_variance":
            raise ValueError(f"{what} fits 'regression_variance' trees (the "
                             "boosting round task); got task="
                             f"{self.config.task!r}")

    def build(self, y, sample_weight=None, assign=None,
              level_callback=None) -> Tree:
        """Build one tree (every rank returns the same tree).  ``y`` /
        ``sample_weight`` / ``assign`` are host arrays or tensors over all
        ``m`` rows (or ``m_pad``); ``assign`` defaults to every valid row at
        the root, and a caller's assignment must keep padding rows at -1.
        The row operands are ``core.tree._operands``' of this rank's rows:
        padding rows hold whatever their staged labels make, and stay inert
        through ``assign``.  On a scattered level, a ``level_callback``
        state's ``phist`` holds only this rank's blocks of the cached
        slots."""
        if sample_weight is not None and self.config.task == "regression":
            raise ValueError("sample_weight is unsupported for the "
                             "label-split 'regression' task (use "
                             "'regression_variance')")
        stats, lbins, yv, _, n_label_bins = _operands(
            y, self.config, self.n_classes,
            lambda x, dtype: self._stage_rows(x, 0, dtype))
        w = (None if sample_weight is None
             else self._stage_rows(sample_weight, 0.0, torch.float32))
        assign = (self._assign0 if assign is None
                  else self._stage_rows(assign, -1, torch.int32))
        return self._grow((stats, lbins, yv), w, assign, 0, n_label_bins,
                          level_callback)[0][0]

    def build_local(self, z, sample_weight=None, assign=None,
                    level_callback=None) -> Tree:
        """``build`` of a ``regression_variance`` tree from this rank's
        blocks as the sharded boosting loop keeps them: ``z`` /
        ``sample_weight`` / ``assign`` are ``[m_loc]`` tensors on the
        builder's device (this rank's rows only, padding rows at assign
        -1), so no row is staged or moved."""
        self._moment_task("build_local")
        return self._grow((None, None, z), sample_weight,
                          self._assign0 if assign is None else assign, 0, 1,
                          level_callback)[0][0]

    def build_batched(self, z, sample_weight=None, assign=None,
                      level_callback=None):
        """Build one ``regression_variance`` tree per row of ``z`` [C, m]
        through one sharded class-stacked build: the mesh twin of
        ``core.tree.build_trees_batched``, with the same returns (per-class
        ``Tree`` views and the stacked ``[C, max_nodes]`` arrays).
        ``sample_weight`` is [C, m]; ``assign`` [C, m] or [m]."""
        self._moment_task("build_batched")
        z = self._stage_rows(z, 0.0, torch.float32)
        w = (self._stage_rows(sample_weight, 0.0, torch.float32)
             if sample_weight is not None else None)
        assign = (self._assign0 if assign is None
                  else self._stage_rows(assign, -1, torch.int32))
        return self._grow((z,), w, assign, z.shape[0], 1, level_callback)

    def build_batched_local(self, z, sample_weight=None, assign=None,
                            level_callback=None):
        """``build_batched`` from this rank's blocks (``[C, m_loc]`` tensors
        on the builder's device, ``assign`` ``[C, m_loc]`` or ``[m_loc]``),
        as the sharded softmax loop keeps them."""
        self._moment_task("build_batched_local")
        return self._grow((z,), sample_weight,
                          self._assign0 if assign is None else assign,
                          z.shape[0], 1, level_callback)

    def _grow(self, rows, w, assign, lanes, n_label_bins, level_callback):
        """One sharded build of one tree (``lanes`` 0, ``rows`` = (stats,
        lbins, y)) or of ``lanes`` class-trees (``rows`` = (z,)) from this
        rank's staged blocks: ``core.tree._grow`` with this rank's chunk
        steps, router and parent-row fetch.  Returns the ``Tree`` views and
        the tree arrays, as the local build does."""
        config = self.config
        kw = _step_kw(config, self.max_nodes, self.b, lanes, n_label_bins,
                      w is not None)

        def chunk(*args, num_slots, use_sub, want_hist):
            self.chunks.append((num_slots, use_sub))
            return make_sharded_step(self.comm, self.dist, kw, num_slots,
                                     use_sub, want_hist, classes=lanes)(*args)

        step, route, callback = _closures(chunk, self._route, self.bins, rows,
                                          self.n_num, self.n_cat, w, lanes,
                                          level_callback)
        subtract = None
        if _subtract_eligible(config, self.m, w is not None):
            # the cache-budget gate uses this rank's feature-block row bytes
            subtract = ((self.k_pad // self.f_shards) * self.b * self.c * 4,
                        config.sub_cache_bytes)
        lead = (lanes,) if lanes else ()
        arrays, n_nodes = _grow(
            step, route, _lane_arrays(self.max_nodes, lanes, self.device),
            assign.expand(*lead, -1).clone(), self.s_cap, self.max_nodes,
            callback, subtract=subtract, max_depth=config.max_depth,
            parent_rows=functools.partial(_parent_rows, self.comm, self.dist,
                                          self.d_shards))
        return _tree_views(arrays, n_nodes, self.max_nodes)


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
