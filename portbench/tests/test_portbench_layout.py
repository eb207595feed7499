"""The files a cell is made of load, and a later change can add a cell and
a per-layer metric as new files only."""
import json
import re
import shutil

import pytest

from portbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads(cfg):
    data = harness.load_config(cfg["name"])
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    assert len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_file_loads_and_reports(w):
    cell = harness.load_cell(w["name"])
    assert cell["config"] == w["config"] and cell["chips"] == w["chips"] == 1
    assert harness.job_class(cell["job"]).__name__ == "Job"
    assert len(w["why"]) <= 200
    e2e, layer = harness.metrics_for(BENCH, w["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found(m):
    assert callable(harness.metric_reader(m["name"]))
    moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", [cell])


def test_new_cell_and_metric_as_new_files(tmp_path):
    """A cell and a metric added as files, with no existing file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench_dir = root / "portbench"
    (bench_dir / "workloads" / "kdd99_10pct_udt.fit_tune_small.json").write_text(
        json.dumps({"name": "kdd99_10pct_udt.fit_tune_small",
                    "config": "kdd99_10pct_udt", "job": "fit_tune",
                    "traffic": {"loop": "closed"}, "chips": 1, "why": "x"}))
    (bench_dir / "metrics" / "jobs_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "kdd99_10pct_udt.fit_tune_small",
                               "config": "kdd99_10pct_udt",
                               "traffic": "fit_tune_small", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append("kdd99_10pct_udt.fit_tune_small")
    bench["per_layer"].append({"name": "jobs_seen", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "tuning", "moves": "udt_job_ms"})
    for p, data in before.items():
        assert p.read_bytes() == data or p.name == "BENCHMARK.json"
    cell = harness.load_cell("kdd99_10pct_udt.fit_tune_small", bench_dir)
    assert harness.load_config(cell["config"], bench_dir)["name"] == "kdd99_10pct_udt"
    e2e, layer = harness.metrics_for(bench, "kdd99_10pct_udt.fit_tune_small")
    assert "jobs_seen" in {m["name"] for m in layer}
    assert "udt_job_ms" in {m["name"] for m in e2e}
    read = harness.metric_reader("jobs_seen", bench_dir)
    assert read(harness.Context(spans=None, profile=None, work={}, window_s=1.0,
                                units=7, rounds_per_unit=1, counters={})) == 7.0
