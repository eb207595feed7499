"""Logical mesh axes of the LM stack and the sharded model's rules
(counterpart of ``repro.models.sharding``).

The reference only declares layouts -- ``param_specs`` / ``cache_specs``
become ``in_shardings`` and ``constrain_act`` a ``with_sharding_constraint``
-- and GSPMD inserts the collectives.  The port has no GSPMD: one process
per rank holds its own block of every tensor, and every collective is
written out through ``core.collectives.Collectives`` with a tag, so a run
can count and budget them.

  * ``param_specs`` / ``cache_specs``: the reference's rules as pure
    functions of names and shapes (a model built on ``torch.device("meta")``
    does), keyed by the port's parameter names.  Each spec is a tuple, one
    entry per dim: ``None``, the model axis name, or the data axes
    (``param_sharding == "fsdp"``: a name, or a tuple of several, the normal
    form of ``jax.sharding.PartitionSpec``).  The port keeps one module per layer,
    so the reference's leading ``None`` of a stacked group leaf is dropped.
  * ``local_block`` / ``assemble``: a rank's block of a whole tensor by its
    spec, and the whole tensor from the blocks.
  * ``set_activation_axes``: the launcher installs the mesh's axes and its
    ``Collectives`` (``COMM``).  Under any installed mesh, 1x1 included,
    the model takes the sharded code (collectives of size 1 return their
    input, so a 1x1 mesh is bit-equal to no mesh); under none, the plain
    path.
  * The conjugate autograd functions over ``COMM`` (``torch.distributed``
    collectives are not autograd-aware): ``to_model_parallel`` (forward
    identity, backward psum over ``model``), ``from_model_parallel``
    (forward psum, backward identity), ``gather_model_parallel`` (a tiled
    all-gather whose backward slices this rank's block: its output must be
    used alike on every model rank), ``gather_weights`` (several split
    weights in one all-gather, the same backward) and ``fsdp_gather`` (over
    the data axes; the backward is a psum-scatter in the step's gradient
    dtype).

On every rank the residual stream ``[B_loc, T, D]`` is the rank's data
block (the caller cuts the batch, ``shard_batch``) and is replicated over
``model``: the reference's ``"btd"`` layout.  ``constrain_act`` is the
identity -- each block places its tensors explicitly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

__all__ = ["MeshAxes", "set_activation_axes", "model_axis_size",
           "heads_shardable", "constrain_act", "on_mesh", "model_split",
           "model_index", "param_specs", "cache_specs", "local_block",
           "assemble", "spec_axes", "mesh_coords", "shard_batch",
           "to_model_parallel", "from_model_parallel", "from_data_parallel",
           "gather_model_parallel", "gather_weights", "fsdp_gather",
           "all_to_all_model", "fsdp_grad_dtype"]


@dataclasses.dataclass
class MeshAxes:
    data: tuple = ("data",)            # batch / fsdp axes ("pod","data") multi-pod
    model: str = "model"
    sizes: dict = dataclasses.field(default_factory=dict)

    def dsize(self):
        return math.prod(self.sizes.get(a, 1) for a in self.data)

    def msize(self):
        return int(self.sizes.get(self.model, 1))


ACT_AXES: MeshAxes | None = None
MESH = None                       # the launcher's DeviceMesh, when it has one
COMM = None                       # its Collectives: every collective of the LM


def set_activation_axes(axes: MeshAxes | None, mesh=None, comm=None):
    """Install a mesh's logical axes and the ``Collectives`` the model
    issues its collectives through (made from ``mesh`` unless given, e.g.
    a ``RecordingCollectives``); ``(None, None)`` removes them."""
    global ACT_AXES, MESH, COMM
    if mesh is not None and comm is None:
        from repro_torch.core.collectives import Collectives
        comm = Collectives(mesh)
    ACT_AXES, MESH, COMM = axes, mesh, comm


def on_mesh() -> bool:
    """A mesh is installed: the model takes its sharded code."""
    return COMM is not None and ACT_AXES is not None


def model_axis_size() -> int:
    return ACT_AXES.msize() if ACT_AXES is not None else 1


def model_index() -> int:
    return COMM.axis_index(ACT_AXES.model) if on_mesh() else 0


def heads_shardable(n: int) -> bool:
    return ACT_AXES is None or n % ACT_AXES.msize() == 0


def model_split(n: int) -> bool:
    """Under a mesh, a dim of ``n`` that the rules put on ``model``."""
    return on_mesh() and n % ACT_AXES.msize() == 0


def constrain_act(x, kind: str):
    """kind: 'btd' | 'btnh_seq' | 'btv' (logits) | 'ecd' (expert buffers).
    The identity: under a mesh each block holds its tensors in their
    layout already (see the module docstring)."""
    del kind
    return x


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _div(n, s):
    return s > 0 and n % s == 0


def _data_entry(axes: MeshAxes):
    """The data axes as one spec entry: a name alone, a tuple of several
    (``PartitionSpec``'s own normal form)."""
    return axes.data[0] if len(axes.data) == 1 else tuple(axes.data)


def _param_spec(cfg, name: str, shape, axes: MeshAxes) -> tuple:
    """The reference's ``param_specs`` rule for one unstacked leaf."""
    m = axes.model
    msz, dsz = axes.msize(), axes.dsize()
    fsdp = cfg.param_sharding == "fsdp"
    dax = _data_entry(axes)

    def fs(dim):
        return dax if (fsdp and _div(dim, dsz)) else None

    def out(*spec):
        return tuple(spec) + (None,) * (len(shape) - len(spec))

    base = shape
    if name == "embed":
        return out(m if _div(base[0], msz) else None, fs(base[1]))
    if name == "head":
        return out(fs(base[0]), m if _div(base[1], msz) else None)
    if name in ("frontend_proj", "router", "conv_w", "lam", "norm1", "norm2",
                "final_norm", "w_a", "w_x", "b_a", "b_x"):
        return out()
    if name in ("wq", "wk", "wv"):
        return (out(fs(base[0]), m, None) if _div(base[1], msz)
                else out(fs(base[0])))
    if name == "wo":
        return (out(m, None, fs(base[2])) if _div(base[0], msz)
                else out(None, None, fs(base[2])))
    if name in ("bq", "bk", "bv"):
        return out(m if _div(base[0], msz) else None)
    if name in ("w_gate", "w_up", "res_w_gate", "res_w_up"):
        if len(base) == 3:                   # moe experts [E, D, F]
            return out(m if _div(base[0], msz) else None, None, fs(base[2]))
        return out(fs(base[0]), m if _div(base[1], msz) else None)
    if name in ("w_down", "res_w_down"):
        if len(base) == 3:                   # [E, F, D]
            return out(m if _div(base[0], msz) else None, fs(base[1]), None)
        return out(m if _div(base[0], msz) else None, fs(base[1]))
    if name in ("w_in", "w_gate_in"):        # rglru / xlstm projections
        return out(None, m if _div(base[1], msz) else None)
    if name == "w_out":
        return out(m if _div(base[0], msz) else None)
    if name in ("w_q", "w_k", "w_v", "w_if"):
        return out(m if _div(base[0], msz) else None)
    if name == "w_gates":
        return out(None, m if _div(base[1], msz) else None)
    return out()


def param_specs(cfg, model, axes: MeshAxes) -> dict:
    """{parameter name: spec} for ``model`` (an ``LM``, on any device, the
    meta device included, or a {name: shape} dict).  The reference's
    ``param_specs`` leaf for leaf (``_reference_layout`` maps the names)."""
    shapes = (model if isinstance(model, dict)
              else {n: p.shape for n, p in model.named_parameters()})
    return {n: _param_spec(cfg, n.rsplit(".", 1)[-1], tuple(s), axes)
            for n, s in shapes.items()}


def cache_specs(cfg, cache, axes: MeshAxes, batch_size: int):
    """Decode-state specs in the cache's own structure (``init_cache``'s
    ``{"layers": [...], "index"}``): batch over the data axes when
    ``batch_size`` divides them, kv heads over model when they divide;
    recurrent states batch-sharded; ``index`` replicated."""
    del cfg
    msz, dsz = axes.msize(), axes.dsize()
    bspec = _data_entry(axes) if batch_size % dsz == 0 else None

    def one(name, leaf):
        shape = tuple(leaf.shape)
        if name in ("k", "v"):               # [B, S, KV, hd]
            return (bspec, None, axes.model if _div(shape[2], msz) else None,
                    None)
        if name == "pos":
            return (bspec, None)
        if not shape:
            return ()
        return (bspec,) + (None,) * (len(shape) - 1)

    def layer(st):
        if isinstance(st, dict):
            return {n: one(n, v) for n, v in st.items()}
        return tuple(one("", v) for v in st)

    return {"layers": [layer(st) for st in cache["layers"]], "index": ()}


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec splits on, in dim order."""
    out = []
    for e in spec:
        if e is not None:
            out += list(e) if isinstance(e, tuple) else [e]
    return tuple(out)


def _entry_axes(e) -> tuple:
    return () if e is None else (tuple(e) if isinstance(e, tuple) else (e,))


def _block_index(axs, coords, sizes):
    """(block index, block count) over ``axs``, mesh-major (the order of
    ``Collectives.data_index`` and of a tiled psum_scatter)."""
    idx, n = 0, 1
    for a in axs:
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return idx, n


def local_block(full, spec, coords: dict, sizes: dict):
    """The block of ``full`` (a tensor or numpy array) that the rank at
    ``coords`` ({axis: index}) holds under ``spec`` on a mesh of ``sizes``
    ({axis: size}).  Pure: no process group."""
    out = full
    for dim, e in enumerate(spec):
        axs = _entry_axes(e)
        if not axs:
            continue
        idx, n = _block_index(axs, coords, sizes)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split over {axs} ({n} blocks)")
        w = out.shape[dim] // n
        sl = [slice(None)] * out.ndim
        sl[dim] = slice(idx * w, (idx + 1) * w)
        out = out[tuple(sl)]
    return out


def assemble(blocks: dict, spec, sizes: dict):
    """The inverse of ``local_block``: ``blocks`` maps each rank's coords
    (a tuple of (axis, index) pairs, or a dict) to its block; blocks that
    differ only on axes the spec does not split are copies, and the first
    is taken."""
    norm = {tuple(sorted(dict(c).items())): b for c, b in blocks.items()}

    def cat(parts, dim):
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts, dim=dim)
        return np.concatenate(parts, axis=dim)

    def rec(dim, fixed):
        # concatenating dim by dim, outermost first, rebuilds the tensor:
        # each level joins the blocks of its own dim built below it
        while dim < len(spec) and not _entry_axes(spec[dim]):
            dim += 1
        if dim == len(spec):
            for c, b in norm.items():
                if all(dict(c)[a] == i for a, i in fixed.items()):
                    return b
            raise KeyError(f"no block at {fixed}")
        axs = _entry_axes(spec[dim])
        parts = []
        for flat in range(math.prod(sizes[a] for a in axs)):
            sub, rem = dict(fixed), flat
            for a in reversed(axs):
                sub[a] = rem % sizes[a]
                rem //= sizes[a]
            parts.append(rec(dim + 1, sub))
        return cat(parts, dim)

    return rec(0, {})


def mesh_coords(comm) -> tuple[dict, dict]:
    """({axis: this rank's index}, {axis: size}) of a ``Collectives``."""
    names = comm.mesh.mesh_dim_names
    return ({a: comm.axis_index(a) for a in names},
            {a: comm.axis_size(a) for a in names})


def shard_batch(batch: dict, axes: MeshAxes | None = None, comm=None) -> dict:
    """This rank's block of a global batch ({name: [B, ...]}): rows over the
    data axes when B divides them, else the whole batch (the ``"btd"``
    rule).  The model's entry points take and return such blocks."""
    axes = ACT_AXES if axes is None else axes
    comm = COMM if comm is None else comm
    if axes is None or comm is None:
        return batch
    coords, sizes = mesh_coords(comm)
    out = {}
    for k, v in batch.items():
        spec = (tuple(axes.data),) if v.shape[0] % axes.dsize() == 0 else ()
        out[k] = local_block(v, spec, coords, sizes)
    return out


# ---------------------------------------------------------------------------
# the conjugate autograd functions
# ---------------------------------------------------------------------------

_GRAD_DTYPE = [None]


@contextlib.contextmanager
def fsdp_grad_dtype(dtype):
    """The dtype ``fsdp_gather``'s backward reduce-scatters in (the train
    step's ``grad_dtype``) while the block runs."""
    prev = _GRAD_DTYPE[0]
    _GRAD_DTYPE[0] = dtype
    try:
        yield
    finally:
        _GRAD_DTYPE[0] = prev


def _maxes():
    return (ACT_AXES.model,)


def _by_dtype(xs):
    """Indices of ``xs`` grouped by dtype, in first-seen order."""
    groups: dict = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.dtype, []).append(i)
    return groups.values()


def _psum_many(xs, axes, tag):
    """psum of several tensors: one collective per dtype among them."""
    out = list(xs)
    for idx in _by_dtype(xs):
        if len(idx) == 1:
            out[idx[0]] = COMM.psum(xs[idx[0]], axes, tag)
            continue
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        flat = COMM.psum(flat, axes, tag)
        o = 0
        for i in idx:
            n = xs[i].numel()
            out[i] = flat[o:o + n].view(xs[i].shape)
            o += n
    return out


class _ToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tag, *xs):
        ctx.tag = tag
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_psum_many([g.contiguous() for g in gs], _maxes(),
                                  ctx.tag))


class _PsumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, tag):
        return COMM.psum(x, axes, tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def to_model_parallel(*xs, tag):
    """Forward identity; backward a psum over ``model`` of each gradient
    (one collective per dtype).  Where a replicated tensor starts a
    computation that differs by model rank."""
    out = _ToModelParallel.apply(tag, *xs)
    return out[0] if len(xs) == 1 else out


def from_model_parallel(x, tag):
    """Forward psum over ``model``; backward identity.  Where the partial
    results of the model ranks are summed into a replicated tensor."""
    return _PsumForward.apply(x, _maxes(), tag)


def from_data_parallel(x, tag):
    """Forward psum over the data axes; backward identity (each data
    rank's share of a global sum, e.g. the loss's numerator)."""
    return _PsumForward.apply(x, tuple(ACT_AXES.data), tag)


def _pack(xs, dims, n):
    """Each tensor's ``dims[i]`` moved first, as ``[n, -1]`` byte rows
    (one row per block), concatenated: one buffer whatever the dtypes."""
    rows = []
    for x, d in zip(xs, dims):
        xt = x.movedim(d, 0).contiguous()
        rows.append(xt.view(torch.uint8).reshape(n, -1))
    return torch.cat(rows, dim=1)


def _unpack(buf, like, dims, n):
    """The inverse of ``_pack`` for tensors shaped like ``like`` with their
    ``dims`` ``n`` times as long."""
    out, o = [], 0
    for x, d in zip(like, dims):
        w = x.numel() * x.element_size()
        cols = buf[:, o:o + w]
        o += w
        shp = list(x.movedim(d, 0).shape)
        shp[0] *= n
        t = cols.contiguous().view(x.dtype).reshape(shp)
        # the parameter's own layout: a product's kernel (and its rounding)
        # may depend on its operand's strides
        out.append(t.movedim(0, d).contiguous())
    return out


def _slice_block(g, d, n, i):
    w = g.shape[d] // n
    return g.narrow(d, i * w, w).contiguous()


class _GatherBlocks(torch.autograd.Function):
    """Blocks, each split along its ``dims[i]`` over ``axes``, whole again
    by one all-gather of their bytes.  Backward: this rank's block of each
    gradient (``reduce=False``: the whole tensors were used alike on every
    rank of ``axes``), or the psum-scatter of the gradients in
    ``fsdp_grad_dtype`` (``reduce=True``: each rank used them on its own
    data)."""

    @staticmethod
    def forward(ctx, axes, dims, tag, reduce, *xs):
        ctx.axes, ctx.dims, ctx.reduce = axes, dims, reduce
        ctx.dtypes = [x.dtype for x in xs]
        buf = COMM.all_gather(_pack(xs, dims, 1).reshape(1, -1), axes, tag)
        return tuple(_unpack(buf, xs, dims, COMM.shards(axes)))

    @staticmethod
    def backward(ctx, *gs):
        n = COMM.shards(ctx.axes)
        if not ctx.reduce:
            i = COMM.data_index(ctx.axes)
            return (None, None, None, None,
                    *[_slice_block(g, d, n, i) for g, d in zip(gs, ctx.dims)])
        gdt = _GRAD_DTYPE[0] or torch.float32
        rows = [g.to(gdt).movedim(d, 0).contiguous().reshape(n, -1)
                for g, d in zip(gs, ctx.dims)]
        got = COMM.psum_scatter(torch.cat(rows, dim=1), ctx.axes,
                                "fsdp_grad")
        out, o = [], 0
        for g, d, dt in zip(gs, ctx.dims, ctx.dtypes):
            w = g.numel() // n
            shp = list(g.movedim(d, 0).shape)
            shp[0] //= n
            out.append(got[0, o:o + w].reshape(shp).movedim(0, d).to(dt))
            o += w
        return (None, None, None, None, *out)


def gather_weights(xs, dims, tag):
    """Several blocks, each split along its ``dims[i]`` over ``model``,
    whole by one all-gather; the backward slices this rank's block (the
    whole tensors must be used alike on every model rank)."""
    return list(_GatherBlocks.apply(_maxes(), tuple(dims), tag, False, *xs))


class _GatherModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tag):
        ctx.dim = dim
        return COMM.all_gather(x, _maxes(), tag, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n, i = COMM.shards(_maxes()), COMM.data_index(_maxes())
        return _slice_block(g, ctx.dim, n, i), None, None


def gather_model_parallel(x, dim, tag):
    """Tiled all-gather over ``model`` along ``dim``; backward the slice of
    this rank's block (the gathered tensor is used alike on every model
    rank: the logits, the sequence-parallel attention's output)."""
    return _GatherModelParallel.apply(x, dim % x.ndim, tag)


def fsdp_gather(xs: dict, specs: dict) -> dict:
    """{name: tensor} with every tensor that ``specs`` splits over the data
    axes (``param_sharding="fsdp"``) gathered whole over them by one
    all-gather (tag ``"fsdp"``); the backward psum-scatters the gradients
    in ``fsdp_grad_dtype`` (tag ``"fsdp_grad"``).  Others pass through."""
    data = tuple(ACT_AXES.data) if on_mesh() else ()
    names, dims = [], []
    for n, x in xs.items():
        spec = specs.get(n, ())
        for d, e in enumerate(spec):
            if e is not None and set(_entry_axes(e)) <= set(data):
                names.append(n)
                dims.append(d)
                break
    if not names:
        return dict(xs)
    got = _GatherBlocks.apply(data, tuple(dims), "fsdp", True,
                              *[xs[n] for n in names])
    return {**xs, **dict(zip(names, got))}


class _AllToAllModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tag):
        ctx.tag = tag
        return _a2a(x, tag)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.tag), None


def _a2a(x, tag):
    """Block ``s`` of dim 0 to model rank ``s``; block ``s`` of the result
    came from rank ``s`` (equal counts)."""
    n = COMM.shards(_maxes())
    rows = x.shape[0] // n
    shp = x.shape
    flat = x.reshape(x.shape[0], -1)
    got = COMM.all_to_all(flat, [rows] * n, [rows] * n, _maxes(), tag)
    return got.reshape(shp)


def all_to_all_model(x, tag):
    """All-to-all over ``model`` of the equal blocks of dim 0; its backward
    is the same exchange."""
    return _AllToAllModel.apply(x, tag)
