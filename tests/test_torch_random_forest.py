"""Port parity for RandomForest (repro_torch.core.forest) on the CPU
against repro.core.forest.RandomForest.  Both packages draw the bootstrap
rows and feature masks from numpy's ``default_rng(seed)`` in the same
order, so with integer class counts (and integer sample weights) every
histogram sum is exact and the trees, vote counts and predictions are
equal."""
import warnings

import numpy as np
import pytest

from repro.core import RandomForest as JRF, TreeConfig as JConfig, fit_bins
from repro.data import make_classification
pytest.importorskip("torch")
from repro_torch.core import RandomForest, TreeConfig, predict_bins
from repro_torch.core.binning import BinnedTable

CPU = "cpu"
EXACT = ("feat", "op", "tbin", "label", "count", "depth", "left", "right",
         "leaf", "parent")


@pytest.fixture(scope="module")
def problem():
    cols, y = make_classification(1000, 8, 3, seed=5, n_cat_features=2,
                                  missing_frac=0.02)
    table = fit_bins(cols, max_num_bins=32)
    port = BinnedTable(bins=np.asarray(table.bins),
                       n_num=np.asarray(table.n_num),
                       n_cat=np.asarray(table.n_cat), metas=[],
                       n_bins=int(table.n_bins))
    return table, port, y


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bootstrap", [True, False])
def test_random_forest_matches_reference(problem, bootstrap, weighted):
    table, port, y = problem
    sw = (np.random.default_rng(2).integers(1, 4, len(y)).astype(np.float32)
          if weighted else None)
    kw = dict(n_trees=3, max_features=0.6, bootstrap=bootstrap, seed=3)
    ref = JRF(config=JConfig(max_depth=5), **kw).fit(table, y,
                                                     sample_weight=sw)
    rf = RandomForest(config=TreeConfig(max_depth=5), **kw).fit(
        port, y, sample_weight=sw, device=CPU)
    assert rf.n_classes == ref.n_classes == 3
    for got, want, nn_got, nn_want in zip(rf.trees, ref.trees, rf.n_nums,
                                          ref.n_nums):
        np.testing.assert_array_equal(nn_got, nn_want)
        n = want.n_nodes
        assert got.n_nodes == n > 7
        for f in EXACT:
            np.testing.assert_array_equal(getattr(got, f)[:n].numpy(),
                                          np.asarray(getattr(want, f))[:n],
                                          err_msg=f)
        np.testing.assert_allclose(got.score[:n].numpy(),
                                   np.asarray(want.score)[:n], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(rf.predict_raw(port.bins),
                                  np.asarray(ref.predict_raw(table.bins)))
    np.testing.assert_array_equal(rf.predict(port.bins),
                                  np.asarray(ref.predict(table.bins)))
    np.testing.assert_array_equal(rf.predict_proba(port.bins),
                                  np.asarray(ref.predict_proba(table.bins)))


def test_forest_votes_equal_a_per_tree_vote_loop(problem):
    _, port, y = problem
    rf = RandomForest(n_trees=3, config=TreeConfig(max_depth=5),
                      seed=1).fit(port, y, device=CPU)
    votes = np.zeros((len(y), rf.n_classes), np.float32)
    for tree, nn in zip(rf.trees, rf.n_nums):
        pred = predict_bins(tree, port.bins, nn, device=CPU).numpy()
        votes[np.arange(len(y)), pred.astype(np.int64)] += 1
    np.testing.assert_array_equal(rf.predict_raw(port.bins), votes)
    np.testing.assert_array_equal(rf.predict(port.bins), votes.argmax(1))
    np.testing.assert_allclose(rf.predict_proba(port.bins).sum(1), 1.0)
    assert (rf.predict(port.bins) == y).mean() > 0.5


def test_rf_n_classes_shim_warns_and_matches_inferred(problem):
    _, port, y = problem
    kw = dict(n_trees=2, config=TreeConfig(max_depth=4), seed=0)
    with pytest.warns(DeprecationWarning, match="n_classes"):
        shim = RandomForest(**kw).fit(port, y, 3, device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        inferred = RandomForest(**kw).fit(port, y, device=CPU)
    assert shim.n_classes == inferred.n_classes == 3
    np.testing.assert_array_equal(shim.predict_raw(port.bins),
                                  inferred.predict_raw(port.bins))
    with pytest.warns(DeprecationWarning):
        wide = RandomForest(**kw).fit(port, y, 5, device=CPU)
    assert wide.predict_raw(port.bins).shape == (len(y), 5)


def test_rf_refit_resets_stacked_cache(problem):
    _, port, y = problem
    rf = RandomForest(n_trees=2, config=TreeConfig(max_depth=5), seed=0)
    rf.fit(port, y, device=CPU)
    first = rf.predict_raw(port.bins)
    assert rf._stacked is not None
    rf.seed = 9
    rf.fit(port, y, device=CPU)
    again = RandomForest(n_trees=2, config=TreeConfig(max_depth=5),
                         seed=9).fit(port, y, device=CPU)
    np.testing.assert_array_equal(rf.predict_raw(port.bins),
                                  again.predict_raw(port.bins))
    assert not np.array_equal(first, rf.predict_raw(port.bins))
    # a refit that fails at validation leaves no cached trees to serve
    with pytest.raises(ValueError):
        rf.fit(port, y, sample_weight=-np.ones(len(y)), device=CPU)
    assert rf._stacked is None


def test_rf_masked_features_are_never_split_on(problem):
    """A feature outside a tree's mask has n_num = n_cat = 0 there: the
    scan never selects it (numeric features show the mask in n_num)."""
    _, port, y = problem
    rf = RandomForest(n_trees=4, max_features=0.3,
                      config=TreeConfig(max_depth=4), seed=4).fit(
        port, y, device=CPU)
    n_masked = 0
    for tree, nn in zip(rf.trees, rf.n_nums):
        feats = tree.feat[:tree.n_nodes].numpy()
        masked = np.flatnonzero((nn == 0) & (port.n_num > 0))
        n_masked += masked.size
        assert not np.isin(feats[feats >= 0], masked).any()
    assert n_masked > 0
