"""Port parity for the single-tree build: repro_torch.core.build_tree on the
CPU against repro.core.build_tree on the same binned table.

Classification trees are field-for-field identical (integer counts are
exact in f32; the split score, a float heuristic, to rtol 1e-6).  The
regression tasks are held to the reference's own tolerances (float moment
channels sum in another order)."""
import dataclasses

import numpy as np
import pytest

from repro.core import TreeConfig as JConfig, build_tree as jbuild, fit_bins
from repro.data import make_classification, make_regression
pytest.importorskip("torch")
from repro_torch.core import tree as ttree
from repro_torch.core.binning import BinnedTable

EXACT = ("feat", "op", "tbin", "label", "count", "depth", "left", "right",
         "leaf", "parent")


def _port_table(table):
    """The reference's BinnedTable carried across as numpy arrays."""
    return BinnedTable(bins=np.asarray(table.bins), n_num=np.asarray(table.n_num),
                       n_cat=np.asarray(table.n_cat), metas=[],
                       n_bins=int(table.n_bins))


def _both(table, y, cfg_kw, *, hist=("segment", "segment"),
          select=("jnp", "torch"), **build_kw):
    want = jbuild(table, y, JConfig(**cfg_kw, hist_backend=hist[0],
                                    select_backend=select[0]), **build_kw)
    got = ttree.build_tree(_port_table(table), y,
                           ttree.TreeConfig(**cfg_kw, hist_backend=hist[1],
                                            select_backend=select[1]),
                           device="cpu", **build_kw)
    return got, want


def _assert_same_tree(got, want, exact=EXACT, score_rtol=1e-6):
    assert got.n_nodes == want.n_nodes
    n = want.n_nodes
    for f in exact:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g[:n], w[:n], err_msg=f)
    np.testing.assert_allclose(got.score.numpy()[:n], np.asarray(want.score)[:n],
                               rtol=score_rtol, err_msg="score")


@pytest.fixture(scope="module")
def hybrid():
    cols, y = make_classification(1500, 6, 3, seed=3, n_cat_features=2,
                                  missing_frac=0.05)
    return fit_bins(cols, max_num_bins=32), y


@pytest.mark.parametrize("sub", [True, False])
@pytest.mark.parametrize("chunk_slots", [0, 16])
def test_segment_classification_identical(hybrid, sub, chunk_slots):
    table, y = hybrid
    got, want = _both(table, y, dict(max_depth=12, chunk_slots=chunk_slots,
                                     sibling_subtraction=sub), n_classes=3)
    assert want.max_tree_depth >= 7
    _assert_same_tree(got, want)


@pytest.mark.parametrize("sub", [True, False])
def test_kernel_backends_identical_to_pallas(sub):
    cols, y = make_classification(300, 4, 2, seed=8)
    table = fit_bins(cols, max_num_bins=16)
    got, want = _both(table, y, dict(max_depth=5, chunk_slots=16,
                                     sibling_subtraction=sub),
                      hist=("pallas", "kernel"), select=("pallas", "kernel"),
                      n_classes=2)
    _assert_same_tree(got, want)


def test_integer_sample_weight_identical(hybrid):
    table, y = hybrid
    w = np.random.default_rng(0).integers(1, 4, size=len(y)).astype(np.float32)
    got, want = _both(table, y, dict(max_depth=10, chunk_slots=16),
                      n_classes=3, sample_weight=w)
    _assert_same_tree(got, want)


def test_min_child_weight_and_node_budget_identical(hybrid):
    table, y = hybrid
    got, want = _both(table, y, dict(max_depth=12, min_child_weight=3.0,
                                     max_nodes=61), n_classes=3)
    _assert_same_tree(got, want)


@pytest.fixture(scope="module")
def reg_table():
    cols, y = make_regression(800, 5, seed=11, n_cat_features=1)
    return fit_bins(cols, max_num_bins=32), y


@pytest.mark.parametrize("task", ["regression", "regression_variance"])
def test_regression_tasks_within_reference_tolerance(reg_table, task):
    """Float targets: moment sums round differently, so a mirrored "<=" /
    ">" pair may swap; the reference's own contract for float moments is
    agreement of predictions to rtol/atol 1e-4 (tests/test_goss.py)."""
    from repro.core import predict_bins as jpredict
    from repro_torch.core import predict_bins as tpredict
    table, y = reg_table
    got, want = _both(table, y, dict(max_depth=6, task=task,
                                     min_samples_split=10))
    np.testing.assert_allclose(
        tpredict(got, table.bins, table.n_num, device="cpu").numpy(),
        np.asarray(jpredict(want, table.bins, table.n_num)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sub", [True, False])
def test_regression_variance_integer_targets_identical(reg_table, sub):
    """Integer-valued targets make every moment channel exact in f32, so
    the variance tree is field-for-field identical."""
    table, y = reg_table
    got, want = _both(table, np.round(y), dict(max_depth=6,
                                               task="regression_variance",
                                               sibling_subtraction=sub))
    _assert_same_tree(got, want)


def test_level_callback_snapshots(hybrid):
    table, y = hybrid
    states = []
    tree = ttree.build_tree(_port_table(table), y,
                            ttree.TreeConfig(max_depth=6), n_classes=3,
                            level_callback=states.append, device="cpu")
    assert [s.depth for s in states] == list(range(2, 2 + len(states)))
    first = states[0]
    # a snapshot is not a view of arrays the build kept writing
    assert int((first.arrays["depth"] > 0).sum()) == 1
    assert first.level_end == first.next_free == 3
    np.testing.assert_array_equal(states[-1].arrays["feat"].numpy(),
                                  tree.feat.numpy())


def test_config_mirrors_reference_fields():
    ours = {f.name: f.default for f in dataclasses.fields(ttree.TreeConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert ours.keys() == theirs.keys()
    assert {k: v for k, v in ours.items() if k != "select_backend"} == \
        {k: v for k, v in theirs.items() if k != "select_backend"}
    with pytest.raises(ValueError):
        ttree.build_tree(_port_table(fit_bins([[1.0, 2.0]])), [0, 1],
                         ttree.TreeConfig(select_backend="kernel",
                                          min_child_weight=1.0), device="cpu")
