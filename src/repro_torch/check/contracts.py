"""Declared performance contracts over the port's real hot paths.

The port's counterpart of ``repro.check.contracts``: the same eleven
contracts, names and order (``core/chunk-step-kernel`` is the reference's
``core/chunk-step-pallas``), each bound to the port's real function and
recorded (``recorder.record``) at the reference's smoke shapes and seeds.
``Contract.build(device)`` records the surface: on the CPU with fake
``cuda`` tensors (nothing runs), on the card for real, under
``set_sync_debug_mode("error")``.

The budgets are the reference's numbers, exact, not headroom.  One
difference is declared: ``dist/grid-counts`` also allows one all-gather
over the model axis, which the reference makes implicitly through its
``shard_map`` ``out_specs`` (``src/repro/core/distributed.py:461``) and
the port makes explicitly.  Where the port makes fewer calls than a
budget allows (``all_gather_many`` packs the per-slot regather into one
call), the budget stays at the reference's number.

Mesh contracts record on ``RecordingCollectives`` over a 2x2 ``("data",
"model")`` mesh, rank (0, 0): the port calls a collective whatever an
axis's size, so the calls depend on the axis names and shard counts, not
on a live process group, and no world is needed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.check.recorder import Surface, record
from repro_torch.check.rules import (CollectiveBudget, DTypePolicy,
                                     KernelBudget, NoDynamicShapes,
                                     NoHostTransfer, Rule, StaticBuffers)

__all__ = ["Contract", "contract", "registry", "smoke_comm", "MESH_AXES",
           "chunk_step_args", "chunk_step_kw", "batched_step_args",
           "batched_step_kw", "level_step_args", "smoke_registry",
           "smoke_tree"]

_REGISTRY: dict[str, "Contract"] = {}


@dataclasses.dataclass(frozen=True)
class Contract:
    """One declared contract: a named surface plus the rules that bind it.
    ``build(device)`` records the surface at smoke shapes; ``ref_name`` is
    the reference's name for it."""
    name: str
    surface: str
    rules: tuple
    build: Callable[[str], Surface] = dataclasses.field(compare=False)
    ref_name: str = ""


def contract(name: str, *, surface: str, rules: tuple[Rule, ...],
             ref_name: str | None = None):
    """Register the decorated builder as contract ``name``."""
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"duplicate contract {name!r}")
        _REGISTRY[name] = Contract(name=name, surface=surface,
                                   rules=tuple(rules), build=fn,
                                   ref_name=ref_name or name)
        return fn
    return deco


def registry() -> dict[str, Contract]:
    """Name -> Contract, declaration order."""
    return dict(_REGISTRY)


# --------------------------------------------------------------------------
# smoke shapes (the reference's, ``repro/check/contracts.py``)
# --------------------------------------------------------------------------

_M, _K, _B, _C, _S, _NODES = 64, 3, 8, 2, 8, 64
MESH_AXES = (("data", 2), ("model", 2))
_WALK_STEPS = 4


def smoke_comm():
    """The recording 2x2 ``(data, model)`` mesh of the mesh contracts, on
    ``cuda`` (a CPU recording runs on fake ``cuda`` tensors too)."""
    from repro_torch.core.collectives import RecordingCollectives
    return RecordingCollectives(MESH_AXES)


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _arrays(n):
    from repro_torch.core.tree import _init_arrays
    return _init_arrays(n)


def chunk_step_args(rng, *, m=_M, k=_K, b=_B, c=_C, s=_S, max_nodes=_NODES,
                pairs=None):
    """``_chunk_step``'s arguments (``_chunk_step(*args, **chunk_step_kw())``);
    the cursors are the host loop's ints.  ``pairs``: rows of
    ``phist_pairs`` (a rank's block of a scattered level; ``s // 2`` by
    default)."""
    return (_t(rng.integers(0, b, size=(m, k)), torch.int32),
            _t(np.eye(c, dtype=np.float32)[rng.integers(0, c, size=m)],
               torch.float32),
            torch.zeros((m,), dtype=torch.int32),                 # lbins
            torch.zeros((m,), dtype=torch.float32),               # y
            _t(rng.integers(0, s, size=m), torch.int32),          # assign
            _arrays(max_nodes + 1),                               # + drop slot
            torch.ones((s // 2 if pairs is None else pairs, k, b, c)),
            torch.full((k,), b, dtype=torch.int32),               # n_num
            torch.zeros((k,), dtype=torch.int32),                 # n_cat
            0, s, s, 2)


def chunk_step_kw(**over):
    kw = dict(num_slots=_S, n_bins=_B, heuristic="info_gain",
              task="classification", min_samples_split=2,
              min_samples_leaf=1, max_depth=5, max_nodes=_NODES,
              hist_backend="segment", select_backend="torch", n_label_bins=1,
              use_sub=True, want_hist=True)
    kw.update(over)
    return kw


# rules shared by every single-device training surface: device-resident,
# collective-free, f32/int32 only, statically shaped
_LOCAL_RULES = (CollectiveBudget(), NoHostTransfer(), DTypePolicy(),
                NoDynamicShapes())


# --------------------------------------------------------------------------
# core: the level-chunk steps (single tree, class-batched, kernel-fused)
# --------------------------------------------------------------------------

@contract("core/chunk-step", surface="core.tree._chunk_step",
          rules=_LOCAL_RULES)
def _build_chunk_step(device: str) -> Surface:
    """The single-device level-chunk step (histogram -> Superfast
    Selection -> node updates) with sibling subtraction on: one device,
    so ZERO collectives and no host round-trips anywhere in the call."""
    from repro_torch.core.tree import _chunk_step
    kw = chunk_step_kw()
    return record(lambda *a: _chunk_step(*a, **kw),
                  *chunk_step_args(np.random.default_rng(0)), device=device,
                  label="core/chunk-step")


def batched_step_args(rng, *, n_cls=3, m=_M, k=_K, b=_B, s=_S,
                      nodes=_NODES):
    """``_chunk_step_classes``' arguments: a softmax round's ``n_cls``
    class-trees over one shared bins table (moment stats, C' = 3)."""
    arrays = {f: v[None].repeat(n_cls, 1).contiguous()
              for f, v in _arrays(nodes + 1).items()}
    return (_t(rng.integers(0, b, size=(m, k)), torch.int32),
            _t(rng.normal(size=(n_cls, m)), torch.float32),        # z [C, M]
            _t(rng.integers(0, s, size=(n_cls, m)), torch.int32),  # assign
            arrays,
            torch.ones((n_cls, s // 2, k, b, 3)),
            torch.full((k,), b, dtype=torch.int32),
            torch.zeros((k,), dtype=torch.int32),
            torch.zeros((n_cls,), dtype=torch.int32),              # cs [C]
            torch.full((n_cls,), s, dtype=torch.int32),            # cn [C]
            torch.full((n_cls,), s, dtype=torch.int32),            # next_free
            2)


def batched_step_kw(**over):
    kw = dict(num_slots=_S, n_bins=_B, min_samples_split=2,
              min_samples_leaf=1, max_depth=5, max_nodes=_NODES,
              hist_backend="segment", select_backend="torch", use_sub=True,
              want_hist=True)
    kw.update(over)
    return kw


@contract("core/chunk-step-batched", surface="core.tree._chunk_step_classes",
          rules=_LOCAL_RULES)
def _build_chunk_step_batched(device: str) -> Surface:
    """The class-batched (multiclass softmax round) level-chunk step: the
    class axis written out over ONE class-stacked histogram call and one
    selection over ``[C * S]`` slots.  The class axis must add no
    collective and no host transfer."""
    from repro_torch.core.tree import _chunk_step_classes
    kw = batched_step_kw()
    return record(lambda *a: _chunk_step_classes(*a, **kw),
                  *batched_step_args(np.random.default_rng(1)),
                  device=device, label="core/chunk-step-batched")


@contract("core/chunk-step-kernel", surface="core.tree._chunk_step[kernel]",
          ref_name="core/chunk-step-pallas",
          rules=(KernelBudget(require_kernel="histogram"), CollectiveBudget(),
                 NoHostTransfer(), NoDynamicShapes()))
def _build_chunk_step_kernel(device: str) -> Surface:
    """The kernel-backed chunk step: the histogram (and the fused sibling
    epilogue) must actually BE a launch of the CUDA kernel -- no silent
    fallback to the plain ``index_add_`` -- and its shared memory per
    block must fit the card's opt-in limit."""
    from repro_torch.core.tree import _chunk_step
    kw = chunk_step_kw(hist_backend="kernel")
    return record(lambda *a: _chunk_step(*a, **kw),
                  *chunk_step_args(np.random.default_rng(2)), device=device,
                  label="core/chunk-step-kernel")


# --------------------------------------------------------------------------
# distributed: the sharded level step, sampler, walk, and TOOT grid
# --------------------------------------------------------------------------

def _dist():
    from repro_torch.core.distributed import DistConfig
    return DistConfig(data_axes=("data",), model_axis="model")


def level_step_args(comm, seed=3):
    """One rank's arguments of the sharded level step at the contract's
    shapes (K = 4 split over the model axis; with subtraction and a
    scattered chunk the rank holds its block of the parent pairs), and the
    step: ``(fn, args)``."""
    from repro_torch.core.distributed import make_sharded_step
    kw = dict(n_bins=_B, heuristic="info_gain", task="classification",
              min_samples_split=2, min_samples_leaf=1, max_depth=5,
              max_nodes=_NODES, hist_backend="segment",
              select_backend="torch", n_label_bins=1, min_child_weight=0.0)
    fn = make_sharded_step(comm, _dist(), kw, _S, use_sub=True,
                           want_hist=True)
    d, f = comm.axis_size("data"), comm.axis_size("model")
    args = chunk_step_args(np.random.default_rng(seed), m=_M // d,
                           k=4 // f, pairs=_S // 2 // d)
    return fn, args


@contract(
    "dist/level-step", surface="core.distributed.make_sharded_step",
    rules=(CollectiveBudget(
               allowed={"reduce_scatter": dict(max=1),
                        "psum": dict(max=1, dtype="float32"),
                        "all_gather": dict(max=11, max_rank=3)},
               max_bulk=1, bulk_rank=4),
           NoHostTransfer(), DTypePolicy(), NoDynamicShapes()))
def _build_dist_level_step(device: str) -> Surface:
    """The sharded level step with subtraction x slot_scatter composed:
    exactly ONE histogram-sized collective per level chunk (the packed
    smaller-child reduce-scatter -- rank 4), one small f32 pair-count
    psum, and only small (rank <= 3) per-slot all-gathers (the ``[P, 9,
    N]`` selection candidates, the packed int32 regather).  Every other
    row-moving collective is banned outright."""
    comm = smoke_comm()
    fn, args = level_step_args(comm)
    return record(fn, *args, device=device, comm=comm,
                  label="dist/level-step")


def _seam_uniforms(round_seed, shard, m_loc, device):
    """The sampler's uniforms on fake tensors: a card generator cannot be
    made without a card, so a CPU recording draws through the seam the
    tests replace (``forest._shard_uniforms``); the card draws its own."""
    return torch.rand(m_loc, device=device)


@contract(
    "dist/goss-sampler", surface="core.distributed.make_sharded_sampler",
    rules=(CollectiveBudget(allowed={"pmax": dict(max=1, scalar=True)}),
           NoHostTransfer(), DTypePolicy(), NoDynamicShapes()))
def _build_dist_sampler(device: str) -> Surface:
    """The sharded GOSS draw: per-shard-quota top set merged by ONE scalar
    pmax per data axis.  No cross-shard row traffic of any spelling, no
    other collective at all."""
    from repro_torch.core import forest
    from repro_torch.core.distributed import make_sharded_sampler
    from repro_torch.core.forest import GossConfig
    from repro_torch.core.losses import get_loss
    comm = smoke_comm()
    goss = GossConfig(0.2, 0.2)
    d_shards = comm.axis_size("data")
    q_top, q_oth = goss.shard_quota(_M, d_shards)
    fn = make_sharded_sampler(comm, _dist(), get_loss("logistic"), goss,
                              _M, q_top, q_oth)
    m_loc = _M // d_shards
    real = forest._shard_uniforms
    if device == "cpu":
        forest._shard_uniforms = _seam_uniforms
    try:
        return record(fn, torch.zeros((m_loc,)), torch.zeros((m_loc,)), 0,
                      device=device, comm=comm, label="dist/goss-sampler")
    finally:
        forest._shard_uniforms = real


@contract(
    "dist/ensemble-walk", surface="core.distributed.make_sharded_walk",
    rules=(CollectiveBudget(allowed={"psum": dict(max=1, dtype="int32")},
                            steps=_WALK_STEPS),
           NoHostTransfer(), DTypePolicy(), NoDynamicShapes()))
def _build_dist_walk(device: str) -> Surface:
    """The sharded raw-score update walk: the feature-parallel node
    predicate costs exactly one int32 psum a step (one bit per example
    over the model axis; the reference's loop body holds the one psum, the
    port's Python loop makes it once per step); raw scores never leave
    their data shard."""
    from repro_torch.core.distributed import make_sharded_walk
    comm = smoke_comm()
    fn = make_sharded_walk(comm, _dist(), num_steps=_WALK_STEPS)
    rng = np.random.default_rng(4)
    m_loc, k_loc = _M // comm.axis_size("data"), 4 // comm.axis_size("model")
    return record(fn, torch.zeros((m_loc,)), _arrays(_NODES),
                  _t(rng.integers(0, _B, size=(m_loc, k_loc)), torch.int32),
                  torch.full((k_loc,), _B, dtype=torch.int32), 0.3,
                  device=device, comm=comm, label="dist/ensemble-walk")


def smoke_tree():
    """A full depth-3 tree over 3 features (7 nodes, padded to ``_NODES``):
    the grid contract's model."""
    from repro_torch.core.tree import TREE_FIELDS, tree_from_numpy
    n, max_nodes = 7, _NODES
    f = {name: np.full(max_nodes, -1, np.int32) for name in TREE_FIELDS}
    f["score"] = np.zeros(max_nodes, np.float32)
    f["label"] = np.zeros(max_nodes, np.float32)
    f["count"] = np.zeros(max_nodes, np.int32)
    f["leaf"] = np.ones(max_nodes, bool)
    f["feat"][:3], f["op"][:3], f["tbin"][:3] = [0, 1, 2], [0, 1, 0], [3, 4, 2]
    f["left"][:3], f["right"][:3], f["leaf"][:3] = [1, 3, 5], [2, 4, 6], False
    f["parent"][:n] = [-1, 0, 0, 1, 1, 2, 2]
    f["depth"][:n] = [1, 2, 2, 3, 3, 3, 3]
    f["count"][:n] = [64, 40, 24, 25, 15, 10, 14]
    f["label"][:n] = [0, 1, 0, 0, 1, 1, 0]
    return tree_from_numpy(f, n)


@contract(
    "dist/grid-counts", surface="core.distributed.sharded_grid_counts",
    rules=(CollectiveBudget(allowed={"psum": dict(max=1, dtype="int32"),
                                     "all_gather": dict(max=1)}),
           NoHostTransfer(), DTypePolicy(), NoDynamicShapes()))
def _build_dist_grid_counts(device: str) -> Surface:
    """The sharded TOOT design-space kernel: each shard prices its grid
    slice locally; exactly ONE int32 psum (order-independent, hence
    bit-identical to the local grid) totals the correct-prediction counts.
    Collective bytes independent of M.  The one all-gather joins the smin
    blocks over the model axis: the reference's ``out_specs`` does that
    join implicitly (``src/repro/core/distributed.py:461``), the port
    calls it."""
    from repro_torch.core.distributed import sharded_grid_counts
    comm = smoke_comm()
    rng = np.random.default_rng(5)
    k, t = 4, 4

    def grid(tree, val_bins, y_val, n_num, smin, mcw, dmax):
        return sharded_grid_counts(
            comm.mesh, _dist(), tree, val_bins, y_val, n_num, smin, mcw,
            dmax, classification=True, device="cuda", comm=comm,
            num_steps=t)

    return record(grid, smoke_tree(),
                  _t(rng.integers(0, _B, size=(_M, k)), torch.int32),
                  _t(rng.integers(0, 2, size=_M), torch.float32),
                  torch.full((k,), _B, dtype=torch.int32),
                  _t([2, 8], torch.int32), _t([0.0, 1.0], torch.float32),
                  _t([3, 5], torch.int32), device=device, comm=comm,
                  label="dist/grid-counts")


# --------------------------------------------------------------------------
# TOOT: the local ensemble sweep scan
# --------------------------------------------------------------------------

@contract("toot/sweep-scan", surface="core.tuning._ensemble_grid_counts",
          rules=_LOCAL_RULES)
def _build_toot_sweep(device: str) -> Surface:
    """The boosted-ensemble design-space scan (a loop over rounds and over
    the dmax axis): single-device pricing of the whole grid, so
    collective-free, host-transfer-free, f32/int32 only."""
    from repro_torch.core.tuning import _ensemble_grid_counts
    rng = np.random.default_rng(6)
    r, m, t = 2, 32, 4
    lab = rng.normal(size=(r, m, t))
    cnt = rng.integers(1, 50, size=(r, m, t))
    cmc = rng.uniform(0, 9, size=(r, m, t))
    tables = [(_t(lab[i], torch.float32), _t(cnt[i], torch.int32),
               _t(cmc[i], torch.float32)) for i in range(r)]
    return record(
        lambda *a: _ensemble_grid_counts(*a, logistic=True), tables,
        _t(rng.integers(0, 2, size=m), torch.float32),
        torch.ones((m,), dtype=torch.bool), _t([2, 8], torch.int32),
        _t([0.0, 1.0], torch.float32), _t([3, 5], torch.int32),
        torch.tensor(0.3), torch.tensor(0.0), device=device,
        label="toot/sweep-scan")


# --------------------------------------------------------------------------
# serve: the routed walk and the bucket's static-buffer executable
# --------------------------------------------------------------------------

def smoke_registry(device="cpu"):
    """A two-tenant registry over synthetic packed stumps (no fit)."""
    from repro_torch.serve.pack import pack_stacked
    from repro_torch.serve.registry import ModelRegistry
    t, n = 2, 8
    feat = np.full((t, n), -1, np.int64)
    op = np.full((t, n), -1, np.int64)
    tbin = np.full((t, n), -1, np.int64)
    left = np.full((t, n), -1, np.int64)
    right = np.full((t, n), -1, np.int64)
    leaf = np.ones((t, n), bool)
    label = np.zeros((t, n), np.float32)
    feat[:, 0], op[:, 0], tbin[:, 0] = 0, 0, 3
    left[:, 0], right[:, 0], leaf[:, 0] = 1, 2, False
    label[:, 1], label[:, 2] = -1.0, 1.0
    tables = dict(feat=feat, op=op, tbin=tbin, left=left, right=right,
                  leaf=leaf, label=label)
    meta = dict(learning_rate=0.3, base=0.0, link_id=0, num_steps=3,
                loss="squared")
    packed = pack_stacked(tables, np.full((4,), 8, np.int32), meta)
    reg = ModelRegistry(capacity=2, device=device)
    reg.add("tenant-a", packed)
    reg.add("tenant-b", packed)
    return reg


def _walk_inputs(seed, b=8):
    rng = np.random.default_rng(seed)
    return (_t(rng.integers(0, 8, size=(b, 4)), torch.int32),
            _t(rng.integers(0, 2, size=b), torch.int32))


@contract("serve/routed-walk", surface="serve.registry.routed_forest_walk",
          rules=_LOCAL_RULES)
def _build_routed_walk(device: str) -> Surface:
    """The mixed-tenant routed forest walk: gathers and elementwise math in
    a Python loop of ``num_steps`` steps -- no collectives, no host
    transfers, and every shape static so one graph serves a whole
    bucket."""
    from repro_torch.serve.registry import routed_forest_walk
    reg = smoke_registry()
    return record(lambda tb, bins, gids: routed_forest_walk(
        tb, bins, gids, num_steps=reg.num_steps), reg.tables,
        *_walk_inputs(7), device=device, label="serve/routed-walk")


@contract("serve/degraded-walk",
          surface="serve.registry.routed_forest_walk[ok-lane]",
          rules=_LOCAL_RULES)
def _build_degraded_walk(device: str) -> Surface:
    """The DEGRADED serve path: the routed walk with a poisoned tenant slot
    resident and the finiteness lane (``ok``) consumed by the caller --
    what the circuit-breaker path runs.  Graceful degradation must be free
    on the device: the ok lane is one elementwise ``isfinite`` on the
    pre-link raw scores, so the degraded call gets the SAME budget as the
    healthy one (quarantine decisions happen host-side on the [B] bool
    lane, after the walk)."""
    from repro_torch.resilience.inject import poison_tenant
    from repro_torch.serve.registry import routed_forest_walk
    reg = smoke_registry()
    poison_tenant(reg, 1)                 # tenant-b's labels become NaN

    def degraded(tb, bins, gids):
        out, ok = routed_forest_walk(tb, bins, gids, num_steps=reg.num_steps)
        return torch.where(ok, out, 0.0), ok

    return record(degraded, reg.tables, *_walk_inputs(8), device=device,
                  label="serve/degraded-walk")


def _buffer_facts(sg, device: str) -> dict:
    """Run the bucket twice with different requests: the runs must write
    ``serve_graph``'s own buffers; on the card also the graph, and the
    device blocks one replay allocates."""
    rng = np.random.default_rng(9)
    ptrs = (sg.bins.data_ptr(), sg.gids.data_ptr())
    same = True
    for _ in range(2):
        rows = rng.integers(0, 8, size=tuple(sg.bins.shape)).astype(np.int32)
        gids = rng.integers(0, 2, size=tuple(sg.gids.shape)).astype(np.int32)
        sg.run(gids, rows)
        same &= ((sg.bins.data_ptr(), sg.gids.data_ptr()) == ptrs
                 and np.array_equal(sg.bins.cpu().numpy(), rows)
                 and np.array_equal(sg.gids.cpu().numpy(), gids))
    facts = dict(same_buffers=bool(same), graph=None, replay_allocs=None)
    if device != "cpu":
        facts["graph"] = sg.graph is not None
        if sg.graph is not None:
            torch.cuda.synchronize()
            key = "allocation.all.allocated"
            before = torch.cuda.memory_stats()[key]
            sg.graph.replay()
            torch.cuda.synchronize()
            facts["replay_allocs"] = torch.cuda.memory_stats()[key] - before
    return facts


@contract("serve/batched-exec", surface="serve.batching.serve_graph",
          rules=(StaticBuffers(), CollectiveBudget(), NoHostTransfer()))
def _build_serve_exec(device: str) -> Surface:
    """The production bucket executable, built exactly as
    ``ForestServer._get_exec`` builds it (``serve_graph(reg, bucket=8)``):
    the walk it captures is recorded on the bucket's static buffers (no
    collective, no host transfer), and two runs must write those very
    buffers, so steady-state serving reuses its memory instead of
    allocating per flush; on the card a graph must be captured and a
    replay allocate nothing."""
    from repro_torch.serve.batching import _serve_fn, serve_graph
    reg = smoke_registry("cpu" if device == "cpu" else "cuda")
    sg = serve_graph(reg, bucket=8)
    surface = record(_serve_fn, sg.tables, sg.bins, sg.gids, sg.num_steps,
                     device=device, label="serve/batched-exec")
    surface.facts["buffers"] = _buffer_facts(sg, device)
    return surface
