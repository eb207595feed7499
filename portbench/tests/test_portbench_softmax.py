"""The softmax cell's files: the cell loads and reports its metrics, the
existing per-layer readers it is listed on read a hand-made profile of it
(and nothing without a profile), the entries that were there stay where
they were, and its counted work matches a hand count of a class-stacked
level."""
import numpy as np
import pytest
import torch

from portbench import harness, trace
from portbench.harness import Context
from portbench.jobs import softmax_boost
from portbench.work_softmax import round_rows, round_work

CELL = "kdd99_10pct_softmax.boost"
READERS = ("bin_s", "hist_roofline_pct.boost", "torch_ops_ms.boost",
           "boost_idle_pct", "boost_mfu_pct")
WORK = {"hist_bytes": 3.35e6, "hist_ops": 1.0, "total_bytes": 6.7e6,
        "total_ops": 1.0}


def _profile(units=1):
    dev = [("tile_kernel(int*)", 0.0, 100.0),
           ("reduce_kernel(float*)", 150.0, 250.0)]
    host = [("portbench.fit", 0.0, 1000.0), ("tree.build", 10.0, 700.0),
            ("tree.level", 50.0, 300.0), ("tree.chunk", 60.0, 200.0)]
    return trace.Profile(dev, host, wall_s=1000e-6, units=units)


def _ctx(profile):
    spans = trace.Spans()
    spans.add("fit_bins", 1.0, 31.5)
    return Context(spans=spans, profile=profile, work=WORK, window_s=2.0,
                   units=1, rounds_per_unit=2, counters={})


def test_cell_loads_and_reports_its_metrics():
    bench = harness.load_benchmark()
    cell = harness.load_cell(CELL)
    cfg = harness.load_config(cell["config"])
    assert cell["config"] == cfg["name"] == "kdd99_10pct_softmax"
    assert harness.job_class(cell["job"]) is softmax_boost.Job
    assert cfg["reduced"] == {} and cfg["model"]["goss"] is None
    assert set(cfg["limits"]) == set(cfg["limit_reasons"])
    e2e, layer = harness.metrics_for(bench, CELL)
    assert {m["name"] for m in e2e} == {"boost_round_ms", "setup_s"}
    assert {m["name"] for m in layer} == set(READERS)


def test_the_cell_is_appended_to_existing_entries_only():
    """Every per-layer entry the cell reports was there before it, with
    the cell last on its list; no entry names a softmax reader."""
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        assert "softmax" not in m["name"]
        if m["name"] in READERS:
            assert m["workloads"][-1] == CELL and len(m["workloads"]) == 2
        else:
            assert CELL not in m["workloads"]
    boost = {m["name"]: m for m in bench["end_to_end"]}["boost_round_ms"]
    assert boost["workloads"] == ["higgs_gbt_goss.boost", CELL]


def test_readers_read_a_hand_made_profile():
    ctx = _ctx(_profile())
    # device busy [0, 100] and [150, 250] of a 1,000 us stretch of 2
    # rounds; the window 2 s over 2 rounds; set-up's binning 30.5 s
    want = {"bin_s": 30.5, "hist_roofline_pct.boost": 100.0 * 1e-6 * 2 / 100e-6,
            "torch_ops_ms.boost": 0.05, "boost_idle_pct": 80.0,
            "boost_mfu_pct": 100.0 * 2e-6 / 1.0}
    for name in READERS:
        read = harness.metric_reader(name)
        assert read(ctx) == pytest.approx(want[name]), name
        if name not in ("bin_s", "boost_mfu_pct"):   # host clock, not a profile
            assert read(_ctx(None)) is None, name


def _tree(feat, op, tbin, left, right, leaf, depth):
    return {"feat": np.array(feat), "op": np.array(op), "tbin": np.array(tbin),
            "label": np.zeros(len(feat), np.float32),
            "count": np.zeros(len(feat), np.int64), "depth": np.array(depth),
            "left": np.array(left), "right": np.array(right),
            "leaf": np.array(leaf)}


def test_work_of_a_class_stacked_level_by_hand():
    """Two lanes over 6 rows of K = 2 features, B = 4 bins: lane 0 splits
    its root on bin <= 1 of feature 0 (3 rows each way, so the left child
    is the one scattered), lane 1 is one leaf.  The root level's launch
    reads every row's codes once for both lanes; the next level's reads
    the 3 rows lane 0 scatters."""
    k, b, m = 2, 4, 6
    bins = torch.tensor([[0, 0], [1, 1], [2, 0], [3, 1], [0, 2], [2, 3]],
                        dtype=torch.int32)
    split = _tree([0, -1, -1], [0, -1, -1], [1, -1, -1], [1, -1, -1],
                  [2, -1, -1], [False, True, True], [1, 2, 2])
    leaf = _tree([-1], [-1], [-1], [-1], [-1], [True], [1])
    n_num = torch.tensor([b, b], dtype=torch.int32)
    rows, union = round_rows([split, leaf], bins, n_num, max_depth=2)
    assert [r.tolist() for r in rows] == [[6, 3, 3], [6]]
    assert union == [6, 3]
    cell = harness.load_cell(CELL)
    cfg = harness.load_config(cell["config"])
    cfg["data"]["features"] = k
    cfg["tree"]["max_depth"] = 2
    job = softmax_boost.Job(config=cfg, cell=cell, seed=1,
                            device=torch.device("cpu"), spans=trace.Spans())
    job.n_classes, job.n_bins, job.y_tr = 2, b, np.zeros(m, np.int32)
    job.trees, job.rows_per_node, job.launch_rows = [split, leaf], rows, [union]
    w = job.work()
    lane_rows = 6 + 3 + 6                   # root twice, lane 0's left child
    cells = 4 * k * b * 3                   # one node's [K, B, 3] block
    assert w["hist_bytes"] == 4 * k * (6 + 3) + 16 * lane_rows + 4 * cells
    assert w["hist_ops"] == 2 * 3 * k * lane_rows
    assert w["select_bytes"] == 4 * cells
    assert w["select_ops"] == 4 * 3 * k * b * 10
    assert w["route_bytes"] == 4 * 6
    assert w == {**round_work([split, leaf], rows, union, n_features=k,
                              n_bins=b),
                 "table_bytes": m * (8 + 2 * (16 + 4 * 2 + 8)),
                 "total_bytes": w["hist_bytes"] + w["select_bytes"]
                 + w["route_bytes"] + m * (8 + 2 * (16 + 8 + 8)),
                 "total_ops": w["hist_ops"] + w["select_ops"]}
