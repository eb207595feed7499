"""Port parity: repro_torch.core.binning against repro.core.binning on the
same raw columns (numbers, numeric strings, categories, missing)."""
import numpy as np
import pytest

from repro.core import binning as jb
from repro.data import make_classification, make_hybrid_table
pytest.importorskip("torch")
from repro_torch.core import binning as tb


def _same_table(a, b):
    np.testing.assert_array_equal(a.bins, b.bins)
    assert a.bins.dtype == b.bins.dtype == np.int32
    np.testing.assert_array_equal(a.n_num, b.n_num)
    np.testing.assert_array_equal(a.n_cat, b.n_cat)
    assert a.n_bins == b.n_bins
    for ma, mb in zip(a.metas, b.metas):
        np.testing.assert_array_equal(ma.edges, mb.edges)
        assert ma.cats == mb.cats and ma.exact == mb.exact
        assert ma.missing_bin == mb.missing_bin


@pytest.mark.parametrize("max_num_bins", [4, 16, 256])
def test_hybrid_table_binning_identical(max_num_bins):
    cols, _ = make_hybrid_table(400, seed=3)
    _same_table(jb.fit_bins(cols, max_num_bins=max_num_bins),
                tb.fit_bins(cols, max_num_bins=max_num_bins))


def test_classification_columns_and_transform_identical():
    cols, _ = make_classification(600, 5, 3, seed=2, n_cat_features=2,
                                  missing_frac=0.05)
    a = jb.fit_bins(cols[:], max_num_bins=32)
    b = tb.fit_bins(cols[:], max_num_bins=32)
    _same_table(a, b)
    new, _ = make_classification(200, 5, 3, seed=9, n_cat_features=2,
                                 missing_frac=0.1)
    np.testing.assert_array_equal(jb.transform(new, a), tb.transform(new, b))


def test_label_classes_identical():
    labels = ["b", "a", "b", 3, "c", 3, None]
    (ya, ca), (yb, cb) = jb.fit_label_classes(labels), tb.fit_label_classes(labels)
    np.testing.assert_array_equal(ya, yb)
    assert ca == cb
