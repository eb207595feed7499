"""Idle share, kernel names and counted work on hand-made inputs."""
import numpy as np
import pytest

from portbench import readers, trace, work
from portbench.harness import Context


def _profile():
    dev = [("void (anonymous namespace)::tile_kernel<true, 4>(int const*, float*)", 0.0, 100.0),
           ("void at::native::vectorized_elementwise_kernel<4, float>(int)", 50.0, 150.0),
           ("split_scan_kernel(float const*)", 300.0, 400.0),
           ("Memcpy HtoD (Pageable -> Device)", 600.0, 700.0)]
    host = [("portbench.build", 0.0, 1000.0), ("aten::nonzero", 160.0, 290.0)]
    return trace.Profile(dev, host, wall_s=1000e-6, units=2)


def test_union_and_idle_share():
    assert trace.union_s([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    p = _profile()
    assert p.busy_s == pytest.approx(350e-6)
    ctx = Context(spans=None, profile=p, work={}, window_s=1, units=1,
                  rounds_per_unit=1, counters={})
    assert readers.idle_pct(ctx) == pytest.approx(65.0)


def test_kernel_names_and_groups():
    assert trace.kernel_function(
        "void (anonymous namespace)::tile_kernel<true, (int)4>(int const*)") == "tile_kernel"
    assert trace.kernel_function("split_scan_kernel(float const*)") == "split_scan_kernel"
    groups = trace.kernel_groups()
    assert "tile_kernel" in groups["histogram"] and "split_scan_kernel" in groups["split_scan"]
    p = _profile()
    assert p.device_s("histogram") == pytest.approx(100e-6)
    assert p.device_s("split_scan") == pytest.approx(100e-6)
    assert p.device_s(exclude_own=True) == pytest.approx(200e-6)
    b = p.breakdown()
    assert b["device_ops"][0][1] == pytest.approx(100e-6)
    assert dict(b["idle_gaps"])["aten::nonzero"] == pytest.approx(150e-6)


def test_work_counts_on_a_hand_made_tree():
    # root 0 (100 rows) -> 1 (30), 2 (70); 2 -> 3 (50), 4 (20)
    tree = dict(depth=np.array([1, 2, 2, 3, 3]),
                left=np.array([1, -1, 3, -1, -1]),
                right=np.array([2, -1, 4, -1, -1]),
                leaf=np.array([False, True, False, True, True]))
    rows = np.array([100, 30, 70, 50, 20])
    w = work.tree_work(tree, rows, n_features=3, n_bins=4, channels=2,
                       weighted=False)
    scattered = 100 + 30 + 20
    assert w["rows_scattered"] == scattered
    assert w["hist_bytes"] == scattered * (3 * 4 + 2 * 4) + 5 * 3 * 4 * 2 * 4
    assert w["select_bytes"] == 5 * 3 * 4 * 2 * 4
    assert w["route_bytes"] == 4 * (100 + 70)
    assert w["hist_ops"] == scattered * 3 * 2
    assert work.roofline_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.roofline_s(0, 67e12) == pytest.approx(1.0)
