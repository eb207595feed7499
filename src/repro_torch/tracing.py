"""The port's spans and counters, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` records: the gate is the
flag torch keeps for that (``torch.autograd.profiler._is_profiler_enabled``),
read once a call.  No environment variable, configuration field or
argument turns it on.  Off, ``span`` returns one shared null context and
the transfer helpers do the transfer alone: nothing is allocated and no
``record_function`` is entered.

On:

* ``span(name)`` opens ``torch.profiler.record_function(name)``, so the
  range lands among the profiler's host events, on the clock of its device
  events, and keeps ``name`` on a stack of open spans;
* ``to_device``, ``to_host`` and ``read_scalar`` count ``h2d_bytes``,
  ``d2h_bytes`` and ``host_syncs`` under the innermost open span
  (``OUTSIDE`` when none is open); ``count`` adds to any other counter
  there, as every build's level loop does with ``stack_slots`` (the ``L *
  S`` slots of each chunk of L trees, L = 1 for one tree) and
  ``stack_slots_used`` (the slots of those that hold a node), and under
  ``tree.level`` ``levels_uncached`` (a level that sibling subtraction
  would cache for the level below but that is wider than
  ``sub_cache_bytes`` holds, so that the level below scatters every row).
  ``counters()`` returns ``{counter: {span: value}}``; ``reset()`` clears
  them.

The counts do not depend on the device.  A read to the host counts the
tensor's bytes and one sync; an upload counts the bytes it builds from
host data (numpy, Python values, or a CPU tensor bound for another
device).  So a run on the CPU with host data given as numpy counts what
the card would copy.  The stack of open spans is the process's: the spans
are opened on the thread that runs the build, the fit or the sweep.

To see them, run a build, a fit or a sweep under the profiler::

    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tracing

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.fit(table, y)
    prof.export_chrome_trace("fit.json")  # the spans over the device timeline
    tracing.counters()                    # syncs and bytes, by span

With no profiler recording, nothing is recorded.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.autograd import profiler as _profiler

__all__ = ["SPANS", "COUNTERS", "OUTSIDE", "span", "to_device", "to_host",
           "read_scalar", "count", "counters", "reset"]

SPANS = (
    # core/tree.py: build_tree, build_trees_batched and their level loop
    "tree.build", "tree.upload", "tree.level", "tree.chunk", "tree.children",
    "tree.route",
    # core/forest.py: GradientBoostedTrees.fit, one output or C a round
    "gbt.fit", "gbt.validate", "gbt.round", "gbt.gradients", "gbt.goss",
    "gbt.update",
    # core/tuning.py: sweep of one tree
    "toot.sweep", "toot.paths", "toot.cost", "toot.front",
)
COUNTERS = ("host_syncs", "h2d_bytes", "d2h_bytes", "stack_slots",
            "stack_slots_used", "levels_uncached")
OUTSIDE = "outside"         # the site of a count made with no span open

_NAMES = frozenset(SPANS)
_NULL = contextlib.nullcontext()
_open: list[str] = []
_counts: dict[str, dict[str, int]] = {c: {} for c in COUNTERS}


class _Span:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        if name not in _NAMES:
            raise ValueError(f"span {name!r} is not in tracing.SPANS")
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        _open.append(self.name)

    def __exit__(self, *exc):
        _open.pop()
        self.rf.__exit__(*exc)


def span(name: str):
    """A context that, while the profiler records, is the profiler range
    ``name`` and the site of the counts made inside it."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def _add(counter: str, value: int) -> None:
    site = _open[-1] if _open else OUTSIDE
    c = _counts[counter]
    c[site] = c.get(site, 0) + value


def to_device(x, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``, counting the
    bytes it builds from host data as ``h2d_bytes``."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if _profiler._is_profiler_enabled and not (
            isinstance(x, torch.Tensor)
            and (x.device.type != "cpu" or t.device.type == "cpu")):
        _add("h2d_bytes", t.numel() * t.element_size())
    return t


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t.detach().cpu().numpy()``, counting its bytes as ``d2h_bytes``
    and one host sync."""
    if _profiler._is_profiler_enabled:
        _add("d2h_bytes", t.numel() * t.element_size())
        _add("host_syncs", 1)
    return t.detach().cpu().numpy()


def read_scalar(t: torch.Tensor):
    """``t.item()``, counting its bytes as ``d2h_bytes`` and one host
    sync."""
    if _profiler._is_profiler_enabled:
        _add("d2h_bytes", t.element_size())
        _add("host_syncs", 1)
    return t.item()


def count(counter: str, value: int) -> None:
    """Add ``value`` to ``counter`` under the innermost open span, while
    the profiler records."""
    if _profiler._is_profiler_enabled:
        _add(counter, int(value))


def counters() -> dict:
    """``{counter: {span: value}}`` of every count since the last
    ``reset``, for each name of ``COUNTERS``."""
    return {c: dict(v) for c, v in _counts.items()}


def reset() -> None:
    for v in _counts.values():
        v.clear()
