"""Port parity for the Algorithm-7 walk, apart from the build: reference
trees (repro.core.build_tree) carried into the port through
``tree_from_numpy`` give identical ``predict_bins`` under runtime
hyper-parameters and identical ``paths``."""
import numpy as np
import jax.numpy as jnp
import pytest

from repro.core import TreeConfig, build_tree, fit_bins, transform
from repro.core import predict as jpred
from repro.data import make_classification, make_regression
pytest.importorskip("torch")
from repro_torch.core import predict as tpred
from repro_torch.core.tree import TREE_FIELDS, tree_from_numpy


def _carry(tree):
    return tree_from_numpy({f: np.asarray(getattr(tree, f))
                            for f in TREE_FIELDS}, tree.n_nodes)


@pytest.fixture(scope="module")
def cls_case():
    cols, y = make_classification(900, 5, 3, seed=4, n_cat_features=2,
                                  missing_frac=0.05)
    table = fit_bins(cols[:], max_num_bins=32)
    tree = build_tree(table, y, TreeConfig(max_depth=14), n_classes=3)
    new, _ = make_classification(300, 5, 3, seed=5, n_cat_features=2,
                                 missing_frac=0.1)
    return tree, transform(new, table), table.n_num


@pytest.mark.parametrize("dmax,smin,mcw", [(1 << 30, 0, 0.0), (3, 0, 0.0),
                                           (1 << 30, 40, 0.0), (6, 10, 2.0),
                                           (1 << 30, 0, 5.0), (1, 0, 0.0)])
def test_predict_bins_runtime_hyperparams_identical(cls_case, dmax, smin, mcw):
    tree, bins, n_num = cls_case
    want = np.asarray(jpred.predict_bins(tree, bins, n_num, max_depth=dmax,
                                         min_samples_split=smin,
                                         min_child_weight=mcw))
    got = tpred.predict_bins(_carry(tree), bins, n_num, max_depth=dmax,
                             min_samples_split=smin, min_child_weight=mcw,
                             device="cpu").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_paths_identical(cls_case):
    tree, bins, n_num = cls_case
    want = np.asarray(jpred.paths(tree, bins, n_num))
    got = tpred.paths(_carry(tree), bins, n_num, device="cpu").numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_regression_tree_walk_identical():
    cols, y = make_regression(600, 4, seed=2)
    table = fit_bins(cols, max_num_bins=32)
    tree = build_tree(table, y, TreeConfig(max_depth=8,
                                           task="regression_variance"))
    want = np.asarray(jpred.predict_bins(tree, table.bins, table.n_num,
                                         min_samples_split=20))
    got = tpred.predict_bins(_carry(tree), table.bins, table.n_num,
                             min_samples_split=20, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_stack_trees_padding_identical(cls_case):
    tree, _, _ = cls_case
    cols, y = make_classification(200, 5, 3, seed=6)
    small = build_tree(fit_bins(cols, max_num_bins=8), y, TreeConfig(max_depth=4),
                       n_classes=3)
    want = jpred.stack_trees([tree, small])
    got = tpred.stack_trees([_carry(tree), _carry(small)])
    assert tuple(got) == tuple(want) == tpred.WALK_FIELDS
    for f in tpred.WALK_FIELDS:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]),
                                      err_msg=f)
    assert tpred._PAD_FILLS == jpred._PAD_FILLS
    assert jnp.asarray(want["leaf"]).dtype == jnp.bool_


def test_walk_per_tree_feature_masks_identical(cls_case):
    """``walk_class_trees`` and ``ops.walk`` with ``n_num [C, K]`` (a
    forest's per-tree feature masks) against the reference's walk of each
    tree under its own mask, over ``stack_trees`` padding."""
    import torch

    from repro_torch.kernels import ops
    tree, bins, n_num = cls_case
    cols, y = make_classification(200, 5, 3, seed=6, n_cat_features=2)
    small = build_tree(fit_bins(cols, max_num_bins=8), y,
                       TreeConfig(max_depth=4), n_classes=3)
    stacked = jpred.stack_trees([tree, small, tree])
    masks = np.array([[1, 1, 1, 1, 1], [1, 0, 1, 1, 0], [0, 1, 1, 0, 1]])
    n_nums = (masks * np.asarray(n_num)[None]).astype(np.int32)
    steps = 14
    want = np.stack([np.asarray(jpred._walk(
        {f: stacked[f][c] for f in jpred.WALK_FIELDS}, jnp.asarray(bins),
        jnp.asarray(n_nums[c]), jnp.int32(1 << 30), jnp.int32(0),
        jnp.float32(0.0), num_steps=steps)) for c in range(3)])
    arrays = {f: torch.from_numpy(np.array(v)) for f, v in stacked.items()}
    got = tpred.walk_class_trees(arrays, bins, n_nums, num_steps=steps,
                                 device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    direct = ops.walk(arrays, torch.as_tensor(bins, dtype=torch.int32),
                      torch.from_numpy(n_nums), num_steps=steps)
    np.testing.assert_array_equal(direct.numpy(), want)
