"""Arithmetic shared by the per-layer metric readers in ``metrics/``.

Each reader returns ``None`` when the run holds nothing to read (no
profile, no device time of the kernels it asks for), and the harness then
leaves the metric out of the result line.
"""
from __future__ import annotations

from portbench.work import roofline_s

__all__ = ["span_mean_ms", "kernel_ms_per_round", "roofline_pct",
           "idle_pct", "mfu_pct", "other_ops_ms_per_round"]


def _rounds(ctx) -> int:
    return ctx.profile.units * ctx.rounds_per_unit


def span_mean_ms(ctx, name: str):
    """Mean host ms of the ``name`` spans inside the measured window."""
    d = ctx.spans.durations_within(name, "window")
    return 1e3 * sum(d) / len(d) if d else None


def kernel_ms_per_round(ctx, group: str):
    """Profiled device ms of one kernel group, per job or round."""
    if ctx.profile is None:
        return None
    s = ctx.profile.device_s(group)
    return 1e3 * s / _rounds(ctx) if s > 0 else None


def roofline_pct(ctx, group: str, work_key: str):
    """Counted work's least time over the group's profiled device time."""
    if ctx.profile is None:
        return None
    s = ctx.profile.device_s(group)
    if s <= 0:
        return None
    bound = roofline_s(ctx.work[f"{work_key}_bytes"], ctx.work[f"{work_key}_ops"])
    return 100.0 * bound * _rounds(ctx) / s


def idle_pct(ctx):
    """Share of the profiled stretch in which nothing ran on the device."""
    p = ctx.profile
    if p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.wall_s)


def mfu_pct(ctx):
    """Least time of a job's or round's counted work over its measured
    time in the (unprofiled) window."""
    per = ctx.window_s / (ctx.units * ctx.rounds_per_unit)
    return 100.0 * roofline_s(ctx.work["total_bytes"], ctx.work["total_ops"]) / per


def other_ops_ms_per_round(ctx):
    """Profiled device ms of every operation that is not one of the
    program's own kernels, per job or round."""
    if ctx.profile is None:
        return None
    s = ctx.profile.device_s(exclude_own=True)
    return 1e3 * s / _rounds(ctx) if s > 0 else None
