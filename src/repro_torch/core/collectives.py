"""Named-axis collectives over a ``torch.distributed`` ``DeviceMesh``.

Counterpart of the ``jax.lax`` collectives that the reference's sharded
build calls inside ``shard_map`` (``psum``, ``pmax``, tiled
``psum_scatter`` / ``all_gather``, ``axis_index``, ``axis_size``).  One
process per rank holds only its own shard; a mesh axis is a named dim of
the ``DeviceMesh`` and that dim's process group, and a rank's coordinate
on a dim is its rank in the dim's group, so the tiled collectives lay
blocks out in the reference's order:

  * ``psum_scatter`` over several axes scatters over each in turn
    (``reduce_scatter_tensor``), so a rank keeps the block at its
    flattened, mesh-major index ``data_index(axes)``;
  * ``all_gather`` over several axes gathers over them in reverse
    (``all_gather_into_tensor``), which undoes that tiling;
  * ``all_to_all`` exchanges rows of uneven counts among the ranks of
    several axes at once (``all_to_all_single`` on one group over them,
    which ``group`` makes once, collectively, for a tuple of several
    axes).

An empty tuple of axes is no collective at all, as in the reference.  A
failed collective raises: there is no fallback.

Every call is counted under (operation, purpose) with the bytes this rank
hands in and the host seconds spent inside the call (the card runs the
collective asynchronously), so a run can show what the sharded build
sends and what the calls cost the host.  With ``log`` set to a list, each
call also appends a ``Call`` there (operation, purpose, bytes, dtype,
shape, reduce op, group size), in call order.

``RecordingCollectives`` has the same interface over named axes of given
sizes and no process group: it communicates nothing, returns outputs of
the right shape (a reduce returns its input, a reduce-scatter this rank's
block, an all-gather the tiled copies, an all-to-all ``recv_counts``
rows of zeros) and logs every call.  The sharded steps call a collective
whatever an axis's size, so the calls they make depend on the axis names
and shard counts only: a recording shows the calls of a real mesh.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.distributed as tdist

__all__ = ["Call", "Collectives", "RecordingCollectives"]


class Call(NamedTuple):
    """One collective call as ``Collectives.log`` keeps it: the operand is
    what this rank hands in (``reduce`` is "sum" / "max" for the reducing
    operations, else None); ``group`` is the number of ranks taking part."""
    op: str
    tag: str
    nbytes: int
    dtype: str
    shape: tuple
    reduce: str | None = None
    group: int = 1


class Collectives:
    """The collectives of one rank on ``mesh`` (a ``DeviceMesh`` with named
    dims).  ``counts[(op, tag)]`` is ``[calls, bytes, host seconds]``."""

    def __init__(self, mesh):
        if not mesh.mesh_dim_names:
            raise ValueError("the mesh needs named dims (init_device_mesh("
                             "..., mesh_dim_names=...))")
        self.mesh = mesh
        names = mesh.mesh_dim_names
        self._groups = {ax: mesh.get_group(ax) for ax in names}
        self._size = {ax: mesh.size(i) for i, ax in enumerate(names)}
        self._index = {ax: mesh.get_local_rank(ax) for ax in names}
        self._flat: dict = {}
        self.counts: dict = {}
        self.log: list | None = None

    def _check(self, axis: str) -> str:
        if axis not in self._size:
            raise ValueError(f"mesh axis {axis!r} not in "
                             f"{self.mesh.mesh_dim_names}")
        return axis

    def axis_size(self, axis: str) -> int:
        return self._size[self._check(axis)]

    def axis_index(self, axis: str) -> int:
        return self._index[self._check(axis)]

    def shards(self, axes) -> int:
        """Number of blocks ``axes`` cut a dimension into."""
        n = 1
        for ax in axes:
            n *= self.axis_size(ax)
        return n

    def data_index(self, axes) -> int:
        """This rank's flattened, mesh-major block index over ``axes``."""
        idx = 0
        for ax in axes:
            idx = idx * self.axis_size(ax) + self.axis_index(ax)
        return idx

    def _call(self, name, tag, x, reduce, ranks, fn, *args, **kw):
        """``fn(*args, **kw)`` (through ``_exchange``) among ``ranks`` ranks,
        counted under (name, tag) with ``x``'s bytes and logged as a
        ``Call``."""
        t0 = time.perf_counter()
        self._exchange(name, fn, args, kw)
        nbytes = x.numel() * x.element_size()
        c = self.counts.setdefault((name, tag), [0, 0, 0.0])
        c[0] += 1
        c[1] += nbytes
        c[2] += time.perf_counter() - t0
        if self.log is not None:
            self.log.append(Call(name, tag, nbytes,
                                 str(x.dtype).removeprefix("torch."),
                                 tuple(x.shape), reduce, ranks))

    def _exchange(self, name, fn, args, kw):
        fn(*args, **kw)

    def _all_reduce(self, x, axes, tag, op, reduce):
        for ax in axes:
            x = x.contiguous().clone()
            self._call("all_reduce", tag, x, reduce, self._size[ax],
                       tdist.all_reduce, x,
                       op=op, group=self._groups[ax])
        return x

    def psum(self, x, axes, tag):
        """Sum over the ranks of each of ``axes``."""
        return self._all_reduce(x, axes, tag, tdist.ReduceOp.SUM, "sum")

    def pmax(self, x, axes, tag):
        """Maximum over the ranks of each of ``axes``."""
        return self._all_reduce(x, axes, tag, tdist.ReduceOp.MAX, "max")

    def psum_scatter(self, x, axes, tag, dim=0):
        """Tiled reduce-scatter along ``dim``: the sum over ``axes``, of which
        this rank keeps block ``data_index(axes)``."""
        for ax in axes:
            n = self.axis_size(ax)
            xt = x.movedim(dim, 0).contiguous()
            if xt.shape[0] % n:
                raise ValueError(f"psum_scatter: {xt.shape[0]} rows do not "
                                 f"split over {n} ranks of {ax!r}")
            out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
            self._call("reduce_scatter_tensor", tag, xt, "sum", n,
                       tdist.reduce_scatter_tensor, out, xt,
                       group=self._groups[ax])
            x = out.movedim(0, dim)
        return x.contiguous()

    def all_gather(self, x, axes, tag, dim=0):
        """Tiled all-gather along ``dim`` over ``axes`` (the inverse of
        ``psum_scatter``'s tiling)."""
        for ax in reversed(tuple(axes)):
            n = self.axis_size(ax)
            xt = x.movedim(dim, 0).contiguous()
            out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
            self._call("all_gather_into_tensor", tag, xt, None, n,
                       tdist.all_gather_into_tensor, out, xt,
                       group=self._groups[ax])
            x = out.movedim(0, dim)
        return x.contiguous()

    def all_gather_many(self, xs, axes, tag, dim=0):
        """``all_gather`` of several same-shape int32 / float32 / bool
        tensors as one collective: their bits are packed into one int32
        tensor, so the values come back exactly."""
        if not axes:
            return list(xs)
        for x in xs:
            if x.dtype not in (torch.int32, torch.float32, torch.bool):
                raise TypeError(f"all_gather_many packs int32 / float32 / "
                                f"bool, got {x.dtype}")
        packed = torch.stack([x.to(torch.int32) if x.dtype == torch.bool
                              else x.contiguous().view(torch.int32)
                              for x in xs], dim=-1)
        got = self.all_gather(packed, axes, tag, dim)
        return [got[..., i].to(torch.bool) if x.dtype == torch.bool
                else got[..., i].contiguous().view(x.dtype)
                for i, x in enumerate(xs)]

    def group(self, axes):
        """The process group over the ranks that differ from this one only
        on ``axes``, its group ranks being their data indices.  One axis is
        that dim's group; several are made here, the first time, by every
        rank of the world together (``new_group`` for every such set), so
        call it on every rank at the same point, e.g. while building."""
        axes = tuple(self._check(ax) for ax in axes)
        if len(axes) == 1:
            return self._groups[axes[0]]
        if axes not in self._flat:
            names = self.mesh.mesh_dim_names
            dims = [names.index(ax) for ax in axes]
            rest = [i for i in range(len(names)) if i not in dims]
            sets = self.mesh.mesh.permute(rest + dims).reshape(
                -1, self.shards(axes)).tolist()    # mesh-major over axes
            me = tdist.get_rank()
            for ranks in sets:
                g = tdist.new_group(ranks)
                if me in ranks:
                    mine = g, ranks
            g, ranks = mine
            if any(tdist.get_group_rank(g, r) != i
                   for i, r in enumerate(ranks)):
                raise ValueError(f"the mesh's ranks must increase along "
                                 f"{axes} (got {ranks})")
            self._flat[axes] = g
        return self._flat[axes]

    def all_to_all(self, x, send_counts, recv_counts, axes, tag):
        """Rows of ``x`` (dim 0) to the ranks of ``axes``: the first
        ``send_counts[0]`` to data index 0, the next to 1, ...; returns the
        rows received, ``recv_counts[i]`` from data index ``i``, in that
        order."""
        x = x.contiguous()
        out = x.new_empty((sum(recv_counts), *x.shape[1:]))
        self._call("all_to_all_single", tag, x, None, self.shards(axes),
                   tdist.all_to_all_single, out, x, list(recv_counts),
                   list(send_counts), group=self.group(axes))
        return out


class RecordingCollectives(Collectives):
    """``Collectives``' interface over named axes of given sizes, as rank 0
    of every axis, with no process group: every call is logged (``log``
    starts as a list) and answered locally with an output of the shape a
    real mesh gives.  ``mesh`` is a stand-in with the dim names and the
    ``cuda`` device type, for the functions that read them.  The default
    is the reference's contract mesh: 2x2 ``("data", "model")``."""

    def __init__(self, axes=(("data", 2), ("model", 2))):
        names = tuple(ax for ax, _ in axes)
        self.mesh = SimpleNamespace(mesh_dim_names=names, device_type="cuda")
        self._size = dict(axes)
        self._index = dict.fromkeys(names, 0)
        self._groups = dict.fromkeys(names)      # no process groups
        self.counts: dict = {}
        self.log: list | None = []

    def group(self, axes):
        for ax in axes:
            self._check(ax)

    def _exchange(self, name, fn, args, kw):
        if name == "reduce_scatter_tensor":       # rank 0's block
            out, xt = args
            out.copy_(xt[:out.shape[0]])
        elif name == "all_gather_into_tensor":
            out, xt = args
            out.view(-1, *xt.shape).copy_(xt.expand(
                out.shape[0] // max(xt.shape[0], 1), *xt.shape))
        elif name == "all_to_all_single":
            args[0].zero_()
