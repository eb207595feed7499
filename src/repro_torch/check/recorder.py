"""Record one call of a real function: the port's counterpart of the
reference's jaxpr walker (``repro.check.walker``).

In JAX a surface is a jaxpr.  Here it is a recording of one call of the
function at smoke shapes (``record``), which holds

  * every aten op the call dispatched, with its input and output dtypes
    and its output shapes (a ``TorchDispatchMode``);
  * every collective it made, as ``core.collectives.Call`` entries of the
    recording ``Collectives`` it was given, plus any call it made to
    ``torch.distributed`` directly, past ``Collectives``;
  * every kernel launch, with its modes and dynamic shared memory (the
    wrappers' launch hook, ``kernels._checks.listener``);
  * every host sync: a copy between host and device memory (either way:
    on the card a blocking copy syncs, and so does an index write whose
    value lives on the host), a host read of a device value,
    ``torch.cuda.synchronize`` and the streams' and events' own.

The call runs in one of two ways:

  * ``device="cpu"``: nothing executes.  The tensor arguments become fake
    ``cuda`` tensors (``FakeTensorMode``: shapes and dtypes without data)
    and the call takes the branches the card takes, kernel wrappers
    included (they report the launch they would make and return empty
    outputs).  A host read of a value raises (``.item()``, ``.tolist()``,
    ``np.asarray``), and so does an op whose output shape depends on the
    data.  PyTorch's Python bindings of a few methods (indexing,
    ``contiguous``, ``to``) enter a CUDA device guard, which a build
    without CUDA lacks; ``_FakeCuda`` runs such a call on fake CPU copies
    and moves the results back, which changes no shape or dtype.
  * ``device="cuda"``: the call runs on the card on real tensors inside
    ``torch.cuda.set_sync_debug_mode("error")``, so every implicit sync
    raises; the dispatch mode records as above.

An op with a data-dependent output shape (``nonzero``, a boolean-mask
index, ``masked_select``, ...) is recorded in ``Surface.dynamic`` and ends
the recording early on both devices (on the card it would sync); a host
sync raises out of ``record`` once it is recorded.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.distributed as tdist
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException,
                                           FakeTensorMode)
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.kernels import _checks

__all__ = ["Op", "Launch", "Surface", "record", "DynamicShape"]

CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)

# ops whose output shape depends on the values of their inputs
_DYNAMIC = frozenset({
    "aten.nonzero", "aten.argwhere", "aten.masked_select", "aten._unique",
    "aten._unique2", "aten.unique_dim", "aten.unique_consecutive",
    "aten.unique_dim_consecutive", "aten.bincount",
})
# torch.distributed's collectives, wrapped while recording: a surface that
# calls one past ``Collectives`` is caught
_TDIST = ("all_reduce", "all_gather", "all_gather_into_tensor",
          "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
          "all_to_all_single", "broadcast", "reduce", "gather", "scatter",
          "send", "recv", "isend", "irecv", "barrier", "all_gather_object",
          "broadcast_object_list")


class DynamicShape(RuntimeError):
    """Raised inside a recording at an op with a data-dependent output
    shape; ``record`` ends the recording there."""


@dataclasses.dataclass(frozen=True)
class Op:
    name: str          # the aten overload, e.g. "aten.index_add_.default"
    dtypes: tuple      # dtypes of the tensor inputs, then of the outputs
    shapes: tuple      # shapes of the tensor outputs


@dataclasses.dataclass(frozen=True)
class Launch:
    kernel: str
    modes: tuple
    # dynamic shared-memory bytes; None: a fake launch whose bytes only the
    # card knows (the linear scan's plan gives them on fake tensors too)
    smem: int | None


@dataclasses.dataclass
class Surface:
    """One recorded call.  ``device`` is where it ran: "cpu" (fake
    tensors, nothing executed) or "cuda"; ``result`` is what the call
    returned (None when a dynamic shape ended it).  ``facts`` holds what a
    contract measured around the call (``StaticBuffers`` reads it)."""
    label: str = ""
    device: str = "cpu"
    ops: list = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)
    launches: list = dataclasses.field(default_factory=list)
    host: list = dataclasses.field(default_factory=list)
    dynamic: list = dataclasses.field(default_factory=list)
    facts: dict = dataclasses.field(default_factory=dict)
    result: Any = None


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _is_dynamic(func, args) -> bool:
    name = str(func.overloadpacket)
    if name in _DYNAMIC:
        return True
    if name == "aten.repeat_interleave" and "output_size" not in str(
            func._schema):
        return isinstance(args[0], torch.Tensor) and len(args) < 2
    if name in ("aten.index", "aten.index_put", "aten.index_put_",
                "aten._index_put_impl_"):
        return any(isinstance(i, torch.Tensor)
                   and i.dtype in (torch.bool, torch.uint8)
                   for i in (args[1] if len(args) > 1 else ()) or ())
    return False


def _dev(x) -> str | None:
    return x.device.type if isinstance(x, torch.Tensor) else None


def _transfer(func, args, kwargs) -> str | None:
    """What host transfer the op makes, if any: a host read of a CUDA
    value, a copy between host and CUDA memory (either way: on the card a
    blocking copy syncs), or an index write whose value tensor lives on
    the host (``x[i] = 1.0`` on a CUDA ``x``)."""
    name = str(func.overloadpacket)
    src = args[0] if args else None
    if name == "aten._local_scalar_dense" and _dev(src) == "cuda":
        return "host read of a device value"
    if name == "aten._to_copy" and kwargs.get("device") is not None:
        pair = (_dev(src), torch.device(kwargs["device"]).type)
    elif name == "aten.copy_" and len(args) > 1:
        pair = (_dev(args[1]), _dev(src))
    elif name in ("aten.index_put", "aten.index_put_",
                  "aten._index_put_impl_") and len(args) > 2:
        pair = (_dev(args[2]), _dev(src))
    else:
        return None
    return {("cuda", "cpu"): "device to host",
            ("cpu", "cuda"): "host to device"}.get(pair)


class _Recorder(TorchDispatchMode):
    """Appends every dispatched op to the surface (``paused``: not the
    device moves ``_FakeCuda`` makes)."""

    def __init__(self, surface: Surface):
        super().__init__()
        self.surface = surface
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused or func.namespace == "prim":   # metadata queries
            return func(*args, **kwargs)
        name = str(func)
        if _is_dynamic(func, args):
            self.surface.dynamic.append(name)
            raise DynamicShape(name)
        what = _transfer(func, args, kwargs)
        if what:
            self.surface.host.append(f"{name} ({what})")
        try:
            out = func(*args, **kwargs)
        except DynamicOutputShapeException:
            self.surface.dynamic.append(name)
            raise DynamicShape(name) from None
        except DataDependentOutputException:
            self.surface.host.append(f"{name} (host read of a device value)")
            raise
        except RuntimeError as e:
            if "synchronizing CUDA operation" in str(e):
                self.surface.host.append(f"{name} (sync)")
            raise
        ins = [_dtype(a) for a in _tensors((args, kwargs))]
        outs = _tensors(out)
        self.surface.ops.append(Op(name, tuple(ins + [_dtype(o) for o in outs]),
                                   tuple(tuple(o.shape) for o in outs)))
        return out


def _tensors(x) -> list:
    found = []
    tree_map(lambda t: found.append(t) if isinstance(t, torch.Tensor)
             else None, x)
    return found


_NO_CUDA = ("not linked with support for cuda", "from the 'CUDA' backend")


def _host_value_write(func, args) -> bool:
    """``x[index] = number`` on a CUDA ``x`` with a tensor index: the
    binding makes the number a host tensor, which the index write copies
    to the card (a sync there)."""
    if func is not torch.Tensor.__setitem__ or len(args) < 3:
        return False
    x, index, value = args[:3]
    index = index if isinstance(index, tuple) else (index,)
    return (_dev(x) == "cuda" and not isinstance(value, torch.Tensor)
            and any(isinstance(i, torch.Tensor) for i in index))


class _FakeCuda(TorchFunctionMode):
    """Runs a call whose Python binding needs a CUDA device guard (which a
    build without CUDA does not have) on fake CPU copies of its CUDA
    arguments, and moves the results back to ``cuda``.  Records what such
    a call copies from the host onto the card, which the card would do."""

    def __init__(self, recorder: _Recorder):
        super().__init__()
        self.recorder = recorder

    def _moved(self, x, device):
        self.recorder.paused += 1
        try:
            return torch.ops.aten._to_copy.default(x, device=device)
        finally:
            self.recorder.paused -= 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _host_value_write(func, args):
            self.recorder.surface.host.append(
                "Tensor.__setitem__ (host to device: a host value written "
                "through a tensor index)")
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            if not any(m in str(e) for m in _NO_CUDA):
                raise

        def down(x):
            if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                return self._moved(x, CPU)
            if (isinstance(x, torch.device) and x.type == "cuda"
                    or isinstance(x, str) and x.startswith("cuda")):
                return CPU
            return x

        def up(x):
            if isinstance(x, torch.Tensor) and x.device.type == "cpu":
                return self._moved(x, CUDA)
            return x

        had_cuda = any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
                       for t in _tensors((args, kwargs)))
        a, k = tree_map(down, (args, kwargs))
        out = tree_map(up, func(*a, **k))
        if not had_cuda:      # host data put on the card: a blocking copy
            self.recorder.surface.host.append(
                f"{getattr(func, '__name__', func)} (host to device)")
        return out


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _syncs(surface: Surface, run: bool):
    """Context managers that record the explicit syncs (and still make
    them on the card, ``run``)."""
    def wrap(what, fn):
        def sync(*a, **kw):
            surface.host.append(f"{what} (explicit sync)")
            return fn(*a, **kw) if run else None
        return sync
    return [_patched(torch.cuda, "synchronize",
                     wrap("torch.cuda.synchronize", torch.cuda.synchronize)),
            _patched(torch.cuda.Stream, "synchronize",
                     wrap("Stream.synchronize", torch.cuda.Stream.synchronize)),
            _patched(torch.cuda.Event, "synchronize",
                     wrap("Event.synchronize", torch.cuda.Event.synchronize))]


def _direct_collectives(surface: Surface):
    """Context managers that record any ``torch.distributed`` collective
    called directly (and make none)."""
    from repro_torch.core.collectives import Call

    def wrap(op):
        def call(*a, **kw):
            t = a[0] if a and isinstance(a[0], torch.Tensor) else None
            surface.collectives.append(Call(
                f"torch.distributed.{op}", "direct",
                0 if t is None else t.numel() * t.element_size(),
                "" if t is None else _dtype(t),
                () if t is None else tuple(t.shape)))
        return call
    return [_patched(tdist, op, wrap(op)) for op in _TDIST
            if hasattr(tdist, op)]


def _to_fake_cuda(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(tuple(x.shape), x.stride(), dtype=x.dtype,
                                   device=CUDA)
    return x


def _to_cuda(x):
    return x.to(CUDA) if isinstance(x, torch.Tensor) else x


def record(fn, *args, device: str = "cuda", comm=None, label: str = "",
           **kwargs) -> Surface:
    """Call ``fn(*args, **kwargs)`` once and record it (module docstring).

    Tensors anywhere in ``args`` / ``kwargs`` (lists, tuples, dicts) are
    moved to the card, or become fake ``cuda`` tensors for
    ``device="cpu"``.  ``comm`` is the recording ``Collectives`` the
    function's collectives go through (its ``log`` is the surface's).  A
    host sync raises out of here once it is recorded; an op with a
    data-dependent output shape ends the recording (``Surface.dynamic``)."""
    dev = torch.device(device)
    surface = Surface(label=label, device=dev.type)
    if comm is not None:
        comm.log = surface.collectives
    recorder = _Recorder(surface)
    old_listener = _checks.listener
    with contextlib.ExitStack() as stack:
        if dev.type == "cpu":
            stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
            args, kwargs = tree_map(_to_fake_cuda, (args, kwargs))
            stack.enter_context(_patched(torch.cuda, "is_available",
                                         lambda: True))
            stack.enter_context(_FakeCuda(recorder))
        else:
            args, kwargs = tree_map(_to_cuda, (args, kwargs))
            old = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            stack.callback(torch.cuda.set_sync_debug_mode, old)
        for cm in _syncs(surface, run=dev.type == "cuda"):
            stack.enter_context(cm)
        for cm in _direct_collectives(surface):
            stack.enter_context(cm)
        _checks.listener = lambda kernel, modes, smem: surface.launches.append(
            Launch(kernel, modes, smem))
        stack.callback(setattr, _checks, "listener", old_listener)
        stack.enter_context(recorder)
        try:
            surface.result = fn(*args, **kwargs)
        except DynamicShape:
            pass
    return surface
