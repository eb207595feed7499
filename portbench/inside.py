"""Arithmetic of the readers of the program's own spans and counters
(``repro_torch.tracing``, on while the profiler records).

The harness profiles one stretch of whole units a run, and the program
counts only while the profiler records, so the program's totals are that
stretch's: a reader divides them by the profiled jobs or rounds.  A
program without the tracing module, or a run without a profile, reads as
nothing (``None``); a count of 0 is a reading.
"""
from __future__ import annotations

__all__ = ["program_counters", "counted_per_round", "idle_in_spans_ms"]


def program_counters():
    """``{counter: {span: value}}`` of the program, or ``None`` when the
    program has no tracing module."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.counters()


def _rounds(ctx) -> int:
    return ctx.profile.units * ctx.rounds_per_unit


def counted_per_round(ctx, names, scale=1.0, counters=None):
    """The counters ``names``, summed over every span, times ``scale``,
    per profiled job or round; ``counters`` stands in for the program's."""
    if ctx.profile is None:
        return None
    c = program_counters() if counters is None else counters
    if c is None:
        return None
    total = sum(sum(c.get(n, {}).values()) for n in names)
    return scale * total / _rounds(ctx)


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """Length shared by two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_spans_ms(ctx, name: str):
    """Host ms under the program's ``name`` spans in which the device ran
    nothing (their union, less the device intervals clipped to it), per
    profiled job or round; ``None`` when the profile holds no such span."""
    if ctx.profile is None:
        return None
    spans = _merged((a, b) for n, a, b in ctx.profile.host if n == name)
    if not spans:
        return None
    busy = _merged((a, b) for _, a, b in ctx.profile.device)
    length = sum(b - a for a, b in spans)
    return (length - _overlap(spans, busy)) / 1e3 / _rounds(ctx)
