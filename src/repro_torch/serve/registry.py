"""Multi-tenant model registry: many forests resident, routed per request
(counterpart of ``repro.serve.registry``).

Every registered ensemble's packed tables (``serve.pack``) live side by
side along a leading **model axis**: ``feat/op/tbin/loff/label`` are
``[G, T, N]``, the per-model feature masks ``n_num`` are ``[G, K]`` and
the serving scalars (``lr``, ``base``, ``link``) are ``[G]``.  One walk
serves a batch that MIXES tenants: each request carries its model id and
every node-table read gathers through it, so routing costs one gather
index, not one executable per tenant.

Capture contract
----------------
The serve executable (``serve.batching.serve_graph``: a CUDA graph on the
card) depends only on the **model-set shape** (``shape_sig``) and the
batch bucket, never on *which* tenants are registered.  The model axis is
padded to ``capacity`` slots up front, so registering a tenant inside the
existing envelope is an array write: same shapes, same graph, no new
capture.  Registering past the capacity, or a tenant with more trees /
nodes / features / steps or a wider field dtype than the current caps,
grows the envelope: ``shape_sig`` changes and the next batch per bucket
captures once.

A captured CUDA graph holds the addresses of the tables it reads.  So the
registry keeps ONE set of device tensors per envelope: every in-envelope
mutation (``add`` into a free slot, ``remove``'s clearing, the chaos
harness's ``poison_tenant``) writes the affected slot into those tensors
in place, on the current stream, and never reallocates them.  Only
envelope growth allocates new tensors, and it always changes
``shape_sig``, so a graph keyed on the old signature can never replay
against them (the server drops such graphs).  The numpy buffers ``_np``
are the host mirror the slot writes come from.

Padding semantics (what makes the padded slots inert):

  * empty model slots / padded trees: node 0 is a leaf (``loff = -1``)
    with label 0 -- it contributes exactly 0 to the ensemble sum;
  * padded node slots are unreachable (no split points into them);
  * padded feature columns have ``n_num = 0`` and are never named by any
    split of a real tree.

Routed predictions are **bit-identical** to each tenant's own
``predict_device`` / ``predict_proba_device``: the walk takes the same
node trajectories, adds the tree lanes in the same left-to-right order
(``core.forest.sum_tree_lanes``; the padded lanes, exactly 0, come last)
and applies the same ``torch.sigmoid``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.forest import sum_tree_lanes
from repro_torch.core.split import evaluate_predicate
from repro_torch.serve.pack import (FAT_STEP_BYTES, LABEL_BYTES, PackedForest,
                                    pack_trees, walk_bytes_per_request)

__all__ = ["ModelRegistry", "Tenant", "routed_forest_walk"]

# model-axis fill values making an empty slot inert (see module docs)
_FILLS = dict(feat=-1, op=-1, tbin=-1, loff=-1, label=0.0)
# the per-slot fields: [G, T, N] node tables, then [G, K] and [G] scalars
_NODE_FIELDS = ("feat", "op", "tbin", "loff", "label")
_SLOT_FIELDS = _NODE_FIELDS + ("n_num", "lr", "base", "link")


def _walk_nodes(tables, bins, gids, num_steps):
    """The routed descent: final node ids [T, B] (int64) and the flat
    (model, tree) row offsets ``base_off`` [T, B] into the [G*T*N] tables.
    Plain tensor code, no host sync: every index is computed on the
    device, so the loop captures into a CUDA graph."""
    _, t, n = tables["feat"].shape
    k = tables["n_num"].shape[1]
    gid = gids.long()
    t_idx = torch.arange(t, dtype=torch.int64, device=bins.device)[:, None]
    base_off = (gid[None, :] * t + t_idx) * n                   # [T, B]
    nn_off = (gid * k)[None, :]                                 # [1, B]
    flat = {f: tables[f].reshape(-1) for f in ("feat", "op", "tbin", "loff")}
    n_num = tables["n_num"].reshape(-1)
    bins_t = bins.t()                                           # [K, B]
    node = torch.zeros((t, bins.shape[0]), dtype=torch.int64,
                       device=bins.device)
    for _ in range(num_steps):
        at = base_off + node
        loff = flat["loff"][at].long()
        f = flat["feat"][at].long().clamp(min=0)
        xb = bins_t.gather(0, f)                                # [T, B]
        pos = evaluate_predicate(xb, n_num[nn_off + f],
                                 flat["op"][at].to(torch.int32),
                                 flat["tbin"][at].to(torch.int32))
        nxt = node + loff + torch.where(pos, 0, 1)
        node = torch.where(loff >= 0, nxt, node)
    return node, base_off


def routed_forest_walk(tables, bins, gids, *, num_steps: int):
    """Walk every tree of each request's model; one batch, many tenants.

    ``tables`` is the registry's device dict (``feat/op/tbin/loff/label``
    [G, T, N], ``n_num`` [G, K] i32, ``lr``/``base`` [G] f32, ``link``
    [G] i32); ``bins`` is the [B, K] int32 pre-binned request batch and
    ``gids`` the [B] model ids.  Per step, per (tree, request): gather the
    packed node record through ``(gid, tree, node)``, evaluate the split
    predicate (``core.split.evaluate_predicate``), and step to ``node +
    loff`` (left) or ``node + loff + 1`` (right) while ``loff >= 0``.
    ``num_steps`` is a Python loop count: a static part of the graph.

    Returns ``(out, ok)``: the linked predictions [B] f32 and the
    per-request finiteness lane ``ok`` [B] bool, judged on the PRE-link
    raw score -- sigmoid squashes an infinite raw score to a finite 1.0 /
    0.0, so a post-link check would hide exactly the poisoned tenants it
    exists to catch."""
    node, base_off = _walk_nodes(tables, bins, gids, num_steps)
    per_tree = tables["label"].reshape(-1)[base_off + node]     # [T, B]
    gid = gids.long()
    raw = tables["base"][gid] + tables["lr"][gid] * sum_tree_lanes(per_tree)
    ok = torch.isfinite(raw)
    return torch.where(tables["link"][gid] == 1, torch.sigmoid(raw), raw), ok


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One registered model's serving metadata (host-side bookkeeping)."""
    name: str
    model_id: int
    n_trees: int
    max_nodes: int
    k: int
    num_steps: int
    meta: dict


class ModelRegistry:
    """Capacity-padded, gather-routed home for many fitted ensembles, on
    ``device`` (``None`` means CUDA; ``"cpu"`` for the plain path).

    ``capacity`` pre-sizes the model axis; ``tree_cap`` / ``node_cap`` /
    ``k_cap`` optionally pre-size the tree / node / feature axes so that
    later registrations never grow the envelope (each growth changes
    ``shape_sig`` and costs one capture per bucket).  ``add`` accepts a
    fitted ``GradientBoostedTrees`` (packed via ``serve.pack``) or a ready
    ``PackedForest``.
    """

    def __init__(self, capacity: int = 4, tree_cap: int = 0,
                 node_cap: int = 0, k_cap: int = 0, *, device=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.device = resolve_device(device)
        self.capacity = capacity
        self.tenants: list[Tenant | None] = []
        self._packed: list[PackedForest | None] = []
        self._tree_cap = tree_cap
        self._node_cap = node_cap
        self._k_cap = k_cap
        self._num_steps = 1
        self._np = None           # host mirror, rebuilt on envelope growth
        self._dev = None          # device tensors, one set per envelope

    # -- registration ------------------------------------------------------

    def add(self, name: str, model) -> int:
        """Register a tenant; returns its model id (the routing index).

        A slot write when the model fits the current envelope (no shape
        change, no new capture); otherwise the envelope grows to fit and
        the host and device buffers are rebuilt (one capture per bucket on
        next use).  A slot freed by ``remove`` is reused first (lowest
        id), so an evict/add churn cycle inside the envelope never grows
        the model axis.

        ``link_id = 2`` (softmax, ``core.losses`` serving ABI) is
        REJECTED: the routed walk produces one scalar per request, so a
        [B, C] multiclass output cannot be represented yet -- refusing at
        registration beats silently mis-serving class-0 logits."""
        packed = model if isinstance(model, PackedForest) else \
            pack_trees(model)
        if int(packed.meta.get("link_id", 0)) == 2:
            raise NotImplementedError(
                "multiclass serving (link_id=2, softmax) is not supported: "
                "the routed walk emits one scalar per request, not [B, C] "
                "class scores; serve each class-tree set as a scalar "
                "tenant or keep multiclass models on predict_device")
        free = [i for i, t in enumerate(self.tenants) if t is None]
        mid = free[0] if free else len(self.tenants)
        grew = mid >= self.capacity
        while mid >= self.capacity:
            self.capacity *= 2
        k = packed.n_num.shape[0]
        grew |= (packed.n_trees > self._tree_cap
                 or packed.max_nodes > self._node_cap or k > self._k_cap)
        self._tree_cap = max(self._tree_cap, packed.n_trees)
        self._node_cap = max(self._node_cap, packed.max_nodes)
        self._k_cap = max(self._k_cap, k)
        steps = int(packed.meta["num_steps"])
        grew |= steps > self._num_steps
        self._num_steps = max(self._num_steps, steps)
        if self._np is not None:
            for f in ("feat", "tbin", "loff"):
                grew |= (np.promote_types(self._np[f].dtype,
                                          getattr(packed, f).dtype)
                         != self._np[f].dtype)
        tenant = Tenant(
            name=name, model_id=mid, n_trees=packed.n_trees,
            max_nodes=packed.max_nodes, k=k, num_steps=steps,
            meta=dict(packed.meta))
        if mid < len(self.tenants):
            self.tenants[mid] = tenant
            self._packed[mid] = packed
        else:
            self.tenants.append(tenant)
            self._packed.append(packed)
        if self._np is None or grew:
            self._rebuild()
        else:
            self._write_slot(mid)
            self._push_slot(mid)
        return mid

    def _alloc(self):
        g, t, n, k = (self.capacity, self._tree_cap, self._node_cap,
                      self._k_cap)
        live = [p for p in self._packed if p is not None]
        dt = {f: functools.reduce(
            np.promote_types, [getattr(p, f).dtype for p in live])
            for f in ("feat", "tbin", "loff")}
        buf = {f: np.full((g, t, n), _FILLS[f], dtype=dt[f])
               for f in ("feat", "tbin", "loff")}
        buf["op"] = np.full((g, t, n), _FILLS["op"], dtype=np.int8)
        buf["label"] = np.zeros((g, t, n), dtype=np.float32)
        buf["n_num"] = np.zeros((g, k), dtype=np.int32)
        buf["lr"] = np.zeros((g,), dtype=np.float32)
        buf["base"] = np.zeros((g,), dtype=np.float32)
        buf["link"] = np.zeros((g,), dtype=np.int32)
        return buf

    def _write_slot(self, mid: int):
        p = self._packed[mid]
        t, n, k = p.n_trees, p.max_nodes, p.n_num.shape[0]
        for f in _NODE_FIELDS:
            self._np[f][mid, :t, :n] = getattr(p, f)
        self._np["n_num"][mid, :k] = p.n_num
        self._np["lr"][mid] = p.meta["learning_rate"]
        self._np["base"][mid] = p.meta["base"]
        self._np["link"][mid] = p.meta["link_id"]

    def _clear_slot(self, mid: int):
        """Reset one model slot to the inert fill values (node 0 becomes a
        label-0 leaf in every tree lane -- it contributes exactly 0 if a
        stale model id ever routes here)."""
        for f in ("feat", "op", "tbin", "loff"):
            self._np[f][mid, :, :] = _FILLS[f]
        self._np["label"][mid, :, :] = _FILLS["label"]
        self._np["n_num"][mid, :] = 0
        self._np["lr"][mid] = 0.0
        self._np["base"][mid] = 0.0
        self._np["link"][mid] = 0

    def _push_slot(self, mid: int):
        """Copy one model slot of the host mirror into the device tensors,
        in place (same addresses, so captured graphs see the write)."""
        for f in _SLOT_FIELDS:
            self._dev[f][mid:mid + 1].copy_(
                torch.from_numpy(self._np[f][mid:mid + 1]))

    def _rebuild(self):
        self._np = self._alloc()
        for mid, p in enumerate(self._packed):
            if p is not None:
                self._write_slot(mid)
        # fresh device tensors: the envelope (and shape_sig) changed
        self._dev = {f: torch.tensor(v, device=self.device)
                     for f, v in self._np.items()}

    # -- eviction ----------------------------------------------------------

    def remove(self, name: str) -> int:
        """Evict the tenant named ``name``; returns the freed model id.

        The slot is cleared to the inert fill values (in place on the
        device) and marked free for the next ``add``.  The envelope NEVER
        shrinks on eviction, so ``shape_sig`` is unchanged and every
        captured serve graph stays valid: evicting (and re-adding within
        the envelope) costs zero captures.  Requests still routing to the
        freed id raise in ``submit`` (unknown model)."""
        for mid, t in enumerate(self.tenants):
            if t is not None and t.name == name:
                break
        else:
            raise KeyError(f"no tenant named {name!r}")
        self.tenants[mid] = None
        self._packed[mid] = None
        self._clear_slot(mid)
        self._push_slot(mid)
        return mid

    # -- serving surface ---------------------------------------------------

    @property
    def num_steps(self) -> int:
        """Global static walk bound: max over tenants (extra steps stay at
        the leaf, so per-tenant outputs are unaffected)."""
        return self._num_steps

    @property
    def shape_sig(self) -> tuple:
        """The model-set shape: everything the serve graph depends on
        besides the batch bucket -- the capture cache's key."""
        if self._np is None:
            raise ValueError("empty registry")
        return (self.capacity, self._tree_cap, self._node_cap, self._k_cap,
                self._num_steps, self._np["feat"].dtype.str,
                self._np["tbin"].dtype.str, self._np["loff"].dtype.str)

    @property
    def tables(self) -> dict:
        """The device-resident model-set tables: the same tensors for the
        life of the envelope."""
        if self._dev is None:
            raise ValueError("empty registry")
        return self._dev

    @property
    def record_bytes(self) -> int:
        """Structural bytes per packed node record at registry dtypes."""
        np_ = self._np
        return (np_["feat"].dtype.itemsize + np_["op"].dtype.itemsize
                + np_["tbin"].dtype.itemsize + np_["loff"].dtype.itemsize)

    def request_cost(self) -> dict:
        """Deterministic per-request accounting (a function of the
        model-set shape, never a clock).  One request row walks
        ``num_steps`` steps over all ``tree_cap`` resident tree lanes; per
        (step, tree) it reads one packed node record plus one example bin
        (4 bytes, layout-independent), and one f32 label per tree at the
        end.  ``ratio`` compares the packed node-table bytes to the same
        walk over the f32/i32 stacked layout."""
        t, steps = self._tree_cap, self._num_steps
        packed = walk_bytes_per_request(t, steps, self.record_bytes)
        fat = walk_bytes_per_request(t, steps, FAT_STEP_BYTES)
        bin_bytes = steps * t * 4
        # per (step, tree): predicate eval ~4 ops + offset add/select ~2;
        # per tree: one multiply-add into the ensemble sum; plus the link.
        flops = steps * t * 6 + t * 2 + 4
        return dict(node_bytes_packed=packed, node_bytes_f32=fat,
                    bin_bytes=bin_bytes, flops=flops,
                    ratio=round(packed / fat, 4),
                    record_bytes=self.record_bytes,
                    label_bytes=LABEL_BYTES)

    def predict(self, model_ids, bins) -> torch.Tensor:
        """Routed predictions [B] on the registry's device for a
        mixed-tenant batch (the eager convenience path; the bucketed
        server in ``serve.batching`` is the production path).
        ``model_ids`` [B] int, ``bins`` [B, K] int32 padded to the
        registry's feature cap (``pad_bins``)."""
        out, _ = self.predict_checked(model_ids, bins)
        return out

    def predict_checked(self, model_ids, bins) -> tuple:
        """Routed predictions PLUS the [B] bool finiteness lane (see
        ``routed_forest_walk`` -- judged on the pre-link raw score)."""
        return routed_forest_walk(
            self.tables,
            torch.as_tensor(np.asarray(bins), dtype=torch.int32,
                            device=self.device),
            torch.as_tensor(np.asarray(model_ids), dtype=torch.int32,
                            device=self.device),
            num_steps=self._num_steps)

    def pad_bins(self, bins) -> np.ndarray:
        """Right-pad [n, k_model] request rows to the registry's feature
        cap (padded columns are never read: no real split names them)."""
        bins = np.asarray(bins, dtype=np.int32)
        if bins.ndim != 2:
            raise ValueError(f"bins must be [n, k], got {bins.shape}")
        pad = self._k_cap - bins.shape[1]
        if pad < 0:
            raise ValueError(f"request has {bins.shape[1]} features, "
                             f"registry cap is {self._k_cap}")
        if pad:
            bins = np.pad(bins, ((0, 0), (0, pad)))
        return bins
