"""A whole run at a small size on the CPU: the last line's schema, the
imports it may not make, and the refusal to run without a card."""
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

SMALL = {"kdd99_10pct_udt.fit_tune": {"rows": 4000},
         "higgs_gbt_goss.boost": {"rows": 12000, "rounds": 3}}


def small_config(cell_name):
    cell = harness.load_cell(cell_name)
    cfg = harness.load_config(cell["config"])
    cfg["data"]["rows"] = SMALL[cell_name]["rows"]
    if "model" in cfg:
        cfg["model"]["rounds"] = SMALL[cell_name]["rounds"]
        cfg["check"]["raw_rows"] = 1000
    return cell, cfg


def run_small(cell_name, trace_on=False, seed=2**31 + 3):
    cell, cfg = small_config(cell_name)
    code, out = harness.execute(harness.load_benchmark(), cell_name, cell, cfg,
                                seed=seed, seconds=0.2, trace_on=trace_on,
                                device=torch.device("cpu"),
                                t_start=time.perf_counter())
    return code, out


@pytest.mark.parametrize("cell_name", sorted(SMALL))
@pytest.mark.parametrize("trace_on", [False, True])
def test_result_line_schema(cell_name, trace_on):
    code, out = run_small(cell_name, trace_on)
    assert code == 0
    res = json.loads(out["stdout"])
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    e2e, layer = harness.metrics_for(harness.load_benchmark(), cell_name)
    want = {m["name"] for m in (layer if trace_on else e2e)}
    assert set(res["metrics"]) <= want
    if not trace_on:
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    if trace_on:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
        assert out["stderr"][-len(res["checks"]):][list(res["checks"]).index(name)] \
            .startswith(f"check {name} ")


SCRIPT = """
import sys, time, torch
sys.path[:0] = [{src!r}, {root!r}]
from portbench import harness
from portbench.tests.test_portbench_run import run_small
run_small({cell!r})
import portbench.reference.binning, portbench.reference.tree
import portbench.reference.toot, portbench.reference.boost
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'repro')]
print('BAD', bad)
"""


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_no_jax_in_a_run(cell_name):
    code = SCRIPT.format(src=str(harness.ROOT / "src"), root=str(harness.ROOT),
                         cell=cell_name)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import portbench.reference.binning, portbench.reference.tree\n"
            "import portbench.reference.toot, portbench.reference.boost\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')))"
            % (str(harness.ROOT / "src"), str(harness.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]
    for p in (harness.BENCH_DIR / "reference").glob("*.py"):
        assert "repro" not in p.read_text().replace("reproduc", "")


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in harness.forbidden_modules()


def test_refuses_without_a_card_or_without_the_program(tmp_path):
    run = [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
           "higgs_gbt_goss.boost", "--seed", "1", "--seconds", "1"]
    if not torch.cuda.is_available():
        out = subprocess.run(run, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""
    import shutil
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    run[1] = str(tmp_path / "portbench" / "run.py")
    out = subprocess.run(run, capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
