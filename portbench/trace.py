"""Spans the harness records around its calls into the program, and the
device trace of a profiled stretch of steady state.

Spans are host-clock intervals kept in memory by name.  A ``Profile``
holds what ``torch.profiler`` saw on the card (kernels, copies, sets) and
on the host (operator and ``record_function`` intervals) over a few whole
units of work, with the host-clock length of that stretch.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import time

__all__ = ["Spans", "Profile", "profile", "kernel_function", "kernel_groups",
           "union_s"]

KERNELS_DIR = pathlib.Path(__file__).resolve().parent / "kernels"


class Spans:
    def __init__(self):
        self.by_name: dict[str, list[tuple[float, float]]] = {}

    def add(self, name: str, t0: float, t1: float) -> None:
        self.by_name.setdefault(name, []).append((t0, t1))

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter())

    def durations(self, name: str) -> list[float]:
        return [b - a for a, b in self.by_name.get(name, [])]

    def durations_within(self, name: str, outer: str) -> list[float]:
        """Durations of ``name`` spans that lie inside an ``outer`` span."""
        out = self.by_name.get(outer, [])
        return [b - a for a, b in self.by_name.get(name, [])
                if any(oa <= a and b <= ob for oa, ob in out)]


def union_s(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def kernel_function(name: str) -> str:
    """A device operation's function name without return type, namespaces,
    template arguments or parameters (``void (anonymous
    namespace)::tile_kernel<true>(int*, ...)`` -> ``tile_kernel``)."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])           # "Memcpy HtoD"
    s = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in s:            # drop template arguments, nested or not
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    s = "".join(out).split("(")[0].strip()
    s = s.split(" ")[-1]
    return s.split("::")[-1]


def kernel_groups() -> dict[str, set[str]]:
    """The program's own kernels by group, from ``kernels/<group>.json``
    (``{"functions": [...]}``): the names a metric reader may ask for."""
    return {p.stem: set(json.loads(p.read_text())["functions"])
            for p in sorted(KERNELS_DIR.glob("*.json"))}


class Profile:
    def __init__(self, device, host, wall_s: float, units: int):
        self.device = device          # [(name, start_us, end_us)]
        self.host = host              # [(name, start_us, end_us)]
        self.wall_s = wall_s
        self.units = units

    @property
    def busy_s(self) -> float:
        return union_s((a, b) for _, a, b in self.device) / 1e6

    def device_s(self, group: str | None = None, *, exclude_own=False) -> float:
        """Summed device seconds of the operations of one kernel group,
        of every operation (``None``), or of every operation that is not
        one of the program's own kernels (``exclude_own``)."""
        groups = kernel_groups()
        own = set().union(*groups.values()) if groups else set()
        names = groups.get(group, set()) if group else None
        total = 0.0
        for name, a, b in self.device:
            fn = kernel_function(name)
            if exclude_own and fn in own:
                continue
            if names is not None and fn not in names:
                continue
            total += b - a
        return total / 1e6

    def breakdown(self, top: int = 10) -> dict:
        ops: dict[str, float] = {}
        for name, a, b in self.device:
            key = kernel_function(name) or name
            ops[key] = ops.get(key, 0.0) + (b - a) / 1e6
        gaps = self._idle_gaps()
        return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                    key=lambda kv: -kv[1])[:top]}

    def _idle_gaps(self) -> dict:
        """Idle device time by the innermost host interval that covers the
        middle of each gap."""
        iv = sorted((a, b) for _, a, b in self.device)
        if not iv:
            return {}
        lo = min([a for _, a, _ in self.host] + [iv[0][0]])
        hi = max([b for _, _, b in self.host] + [iv[-1][1]])
        gaps, end = [], lo
        for a, b in iv:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        # one sweep: the stack holds the host intervals open at ``mid``,
        # the innermost (latest started) on top
        host = sorted(self.host, key=lambda e: e[1])
        out: dict[str, float] = {}
        stack, i = [], 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            key = stack[-1][0] if stack else "host outside any operation"
            out[key] = out.get(key, 0.0) + (b - a) / 1e6
        return out


def profile(fn, units: int) -> Profile:
    """Run ``fn()`` (``units`` whole units of work) under ``torch.profiler``
    with CPU and CUDA activity, the card synchronised on both sides."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    device, host = [], []
    for ev in prof.events():
        rec = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type != DeviceType.CUDA:
            host.append(rec)
        elif not (getattr(ev, "is_user_annotation", False)
                  or ev.name.startswith("portbench.")):
            device.append(rec)          # a kernel, a copy or a set
    return Profile(device, host, wall, units)
