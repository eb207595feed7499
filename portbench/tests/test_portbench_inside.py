"""The readers of the program's own spans and counters on hand-made
profiles and counters, and the six metrics added as new files."""
import json
import shutil
import sys

import pytest

from portbench import harness, inside, trace
from portbench.harness import Context

READERS = {
    "udt_copy_mb": "kdd99_10pct_udt.fit_tune",
    "udt_syncs": "kdd99_10pct_udt.fit_tune",
    "udt_level_idle_ms": "kdd99_10pct_udt.fit_tune",
    "boost_copy_mb": "higgs_gbt_goss.boost",
    "boost_syncs": "higgs_gbt_goss.boost",
    "boost_level_idle_ms": "higgs_gbt_goss.boost",
}
COUNTS = {"host_syncs": {"tree.children": 14, "toot.cost": 9, "gbt.fit": 1},
          "h2d_bytes": {"tree.upload": 3_000_000, "toot.paths": 500_000},
          "d2h_bytes": {"toot.cost": 1_500_000}}


def _profile(units=2):
    # device: [0, 100], [150, 250], [400, 450], [900, 1000] (us)
    dev = [("tile_kernel(int*)", 0.0, 100.0),
           ("Memcpy HtoD (Pageable -> Device)", 150.0, 250.0),
           ("reduce_kernel(float*)", 180.0, 220.0),
           ("split_scan_kernel(float*)", 400.0, 450.0),
           ("Memcpy DtoH (Device -> Pageable)", 900.0, 1000.0)]
    # two levels inside a build: [50, 300] and [350, 600], with a chunk
    # nested in each; a level after the build, [800, 850], on no device work
    host = [("portbench.build", 0.0, 1000.0),
            ("tree.build", 10.0, 700.0),
            ("tree.level", 50.0, 300.0),
            ("tree.chunk", 60.0, 200.0),
            ("tree.level", 350.0, 600.0),
            ("tree.chunk", 360.0, 500.0),
            ("tree.level", 800.0, 850.0),
            ("aten::add", 120.0, 130.0)]
    return trace.Profile(dev, host, wall_s=1000e-6, units=units)


def _ctx(profile, rounds_per_unit=1):
    return Context(spans=None, profile=profile, work={}, window_s=1.0,
                   units=5, rounds_per_unit=rounds_per_unit, counters={})


def test_counted_per_round():
    ctx = _ctx(_profile(units=2))
    assert inside.counted_per_round(ctx, ("host_syncs",), counters=COUNTS) == 12.0
    mb = inside.counted_per_round(ctx, ("h2d_bytes", "d2h_bytes"), scale=1e-6,
                                  counters=COUNTS)
    assert mb == pytest.approx(2.5)
    rounds = _ctx(_profile(units=1), rounds_per_unit=4)
    assert inside.counted_per_round(rounds, ("host_syncs",), counters=COUNTS) == 6.0


def test_a_count_of_zero_is_a_reading_and_no_profile_is_none():
    ctx = _ctx(_profile())
    empty = {"host_syncs": {}, "h2d_bytes": {}, "d2h_bytes": {}}
    assert inside.counted_per_round(ctx, ("host_syncs",), counters=empty) == 0.0
    assert inside.counted_per_round(ctx, ("host_syncs",), counters={}) == 0.0
    assert inside.counted_per_round(_ctx(None), ("host_syncs",),
                                    counters=COUNTS) is None
    assert inside.idle_in_spans_ms(_ctx(None), "tree.level") is None


def test_idle_inside_nested_and_disjoint_spans():
    ctx = _ctx(_profile(units=2))
    # level [50, 300]: busy [50, 100] and [150, 250], idle 100; level
    # [350, 600]: busy [400, 450], idle 200; level [800, 850]: idle 50
    assert inside.idle_in_spans_ms(ctx, "tree.level") == pytest.approx(0.350 / 2)
    # chunks [60, 200] and [360, 500]: idle [100, 150] and [360, 400],
    # [450, 500]
    assert inside.idle_in_spans_ms(ctx, "tree.chunk") == pytest.approx(0.140 / 2)
    # spans that overlap count their union once: [50, 320] is idle 120
    p = _profile(units=1)
    p.host.append(("tree.level", 280.0, 320.0))
    assert inside.idle_in_spans_ms(_ctx(p), "tree.level") == pytest.approx(0.370)
    assert inside.idle_in_spans_ms(ctx, "tree.route") is None
    whole = inside.idle_in_spans_ms(ctx, "tree.level") * 2
    idle = (ctx.profile.wall_s - ctx.profile.busy_s) * 1e3
    assert whole <= idle


def test_without_the_tracing_module_the_readers_read_nothing(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert inside.program_counters() is None
    ctx = _ctx(_profile())
    for name in READERS:
        if "idle" not in name:
            assert harness.metric_reader(name)(ctx) is None
    parent = trace.Profile(ctx.profile.device,
                           [h for h in ctx.profile.host
                            if not h[0].startswith("tree.")], 1e-3, 2)
    assert harness.metric_reader("udt_level_idle_ms")(_ctx(parent)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader(name, monkeypatch):
    from repro_torch import tracing
    monkeypatch.setattr(tracing, "counters", lambda: COUNTS)
    read = harness.metric_reader(name)
    ctx = _ctx(_profile(units=2))
    want = {"copy_mb": 2.5, "syncs": 12.0, "level_idle_ms": 0.175}
    assert read(ctx) == pytest.approx(want[name.split("_", 1)[1]])
    assert read(_ctx(None)) is None


def test_six_metrics_added_as_new_files(tmp_path):
    """The six entries and their readers, added to a checkout that lacks
    them, change no file that was there but ``BENCHMARK.json``, whose
    other entries stay as they were."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    full = harness.load_benchmark()
    added = [m for m in full["per_layer"] if m["name"] in READERS]
    assert [m["name"] for m in full["per_layer"][-6:]] == list(READERS)
    lacking = dict(full, per_layer=full["per_layer"][:-6])
    new = [root / "portbench" / "metrics" / f"{n}.py" for n in READERS]
    new.append(root / "portbench" / "inside.py")
    kept = {p: p.read_bytes() for p in new}
    for p in new:
        p.unlink()
    (root / "BENCHMARK.json").write_text(json.dumps(lacking))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    for p, data in kept.items():
        p.write_bytes(data)
    (root / "BENCHMARK.json").write_text(json.dumps(full))
    for p, data in before.items():
        assert p.read_bytes() == data or p.name == "BENCHMARK.json"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert bench["per_layer"][:-6] == lacking["per_layer"]
    for k in ("configs", "workloads", "end_to_end", "run_seconds", "command",
              "paths"):
        assert bench[k] == lacking[k]
    for m in added:
        assert m["workloads"] == [READERS[m["name"]]]
        assert m["source"] == "device_trace"
        _, layer = harness.metrics_for(bench, READERS[m["name"]])
        assert m["name"] in {x["name"] for x in layer}
        for cell in set(READERS.values()) - {READERS[m["name"]]}:
            _, layer = harness.metrics_for(bench, cell)
            assert m["name"] not in {x["name"] for x in layer}
        read = harness.metric_reader(m["name"], root / "portbench")
        assert read(_ctx(None)) is None
