"""What every cell shares: finding its files by name, the measured window,
the result line and the guard against JAX in the process.

A cell is ``workloads/<cell>.json`` (its configuration, job kind, traffic
parameters, chips, why); its configuration is ``configs/<config>.json``;
its job kind is the module ``jobs/<kind>.py``; a per-layer metric is the
module ``metrics/<metric>.py``.  Which metrics a cell reports comes from
``BENCHMARK.json`` at the checkout's root.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time

from portbench import trace

__all__ = ["ROOT", "BENCH_DIR", "load_benchmark", "load_cell", "load_config",
           "job_class", "metric_reader", "metrics_for", "forbidden_modules",
           "run_window", "result_line", "Context", "FORBIDDEN", "execute"]

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load_cell(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "workloads" / f"{name}.json")


def load_config(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "configs" / f"{name}.json")


def job_class(kind: str):
    """The ``Job`` class of ``jobs/<kind>.py``."""
    return importlib.import_module(f"portbench.jobs.{kind}").Job


def metric_reader(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """``read(ctx)`` of ``metrics/<name>.py`` (a metric's name may hold
    dots, so the file is loaded by path)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str):
    """``(end_to_end, per_layer)`` entries of ``bench`` that ``cell``
    reports: a metric with ``workloads`` names its cells; one without it is
    in every cell (a per-layer one: every cell that reports the metric it
    moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its kin's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_window(unit, seconds: float, spans) -> tuple[float, int]:
    """Run ``unit()`` back to back until ``seconds`` have passed; the unit
    in progress then completes.  Returns (elapsed seconds, units)."""
    t0 = time.perf_counter()
    n = 0
    while True:
        unit()
        n += 1
        t = time.perf_counter()
        if t - t0 >= seconds:
            spans.add("window", t0, t)
            return t - t0, n


class Context:
    """What a per-layer metric reader may read."""

    def __init__(self, *, spans, profile, work, window_s, units,
                 rounds_per_unit, counters):
        self.spans = spans
        self.profile = profile
        self.work = work            # counted work of one unit
        self.window_s = window_s
        self.units = units
        self.rounds_per_unit = rounds_per_unit
        self.counters = counters


def _number(x):
    x = float(x)
    return x if math.isfinite(x) else str(x)


def result_line(*, correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": _number(v), "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": _number(v), "limit": _number(lim)}
                     for k, (v, lim) in checks.items()}
    return json.dumps(out)


def execute(bench, workload, cell, config, *, seed, seconds, trace_on,
            device, t_start):
    """One run of a cell on ``device``: set-up, the window, with
    ``trace_on`` a profiled stretch, the check.  Returns ``(exit code,
    {"stdout": result line or None, "stderr": [lines]})``."""
    import torch
    on_cuda = device.type == "cuda"
    e2e, layer = metrics_for(bench, workload)
    spans = trace.Spans()
    job = job_class(cell["job"])(config=config, cell=cell, seed=seed,
                                 device=device, spans=spans)
    job.setup()
    if on_cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    window_s, units = run_window(job.unit, seconds, spans)
    prof = trace.profile(job.profiled, job.profile_units) if trace_on else None
    chips = int(cell["chips"])
    dev_info = {"platform": "gpu" if on_cuda else device.type,
                "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
                "count": chips,
                "memory_peak_bytes": int(max(
                    torch.cuda.max_memory_allocated(i) for i in range(chips))
                    if on_cuda else 0)}
    job.release()
    checks, failed = job.check(units)
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    metrics, breakdown = {}, None
    if trace_on:
        ctx = Context(spans=spans, profile=prof, work=job.work(),
                      window_s=window_s, units=units,
                      rounds_per_unit=job.rounds_per_unit,
                      counters=job.counters)
        for m in layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        dev_info["busy_s"] = prof.busy_s
        dev_info["window_s"] = prof.wall_s
        breakdown = prof.breakdown()
    else:
        values = job.end_to_end(window_s, units)
        values["setup_s"] = setup_s
        for m in e2e:
            metrics[m["name"]] = (values[m["name"]], m["unit"])
    loaded = forbidden_modules()
    if loaded:
        return 4, {"stdout": None, "stderr": [
            "JAX or the JAX package is loaded: " + ", ".join(loaded)]}
    err = [f"counters {json.dumps(job.counters)}"]
    err += [f"check {k} {v!r} limit {lim!r}" for k, (v, lim) in checks.items()]
    return 0, {"stdout": result_line(
        correct=correct, attempted=units, failed=failed, metrics=metrics,
        device=dev_info, checks=checks, breakdown=breakdown), "stderr": err}
