"""Port parity: best_splits / best_splits_kernel / evaluate_predicate against
their own counterparts in repro.core.split, including the cross-feature tie
on which the two selection rules disagree."""
import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from repro.core import split as js
from repro_torch.core import split as ts


def _hist(seed, s=5, k=4, b=9, c=3):
    rng = np.random.default_rng(seed)
    hist = rng.poisson(2, size=(s, k, b, c)).astype(np.float32)
    n_num = rng.integers(0, b, size=k).astype(np.int32)
    n_cat = np.minimum(rng.integers(0, 4, size=k), b - n_num).astype(np.int32)
    return hist, n_num, n_cat


def _tie_hist():
    """Two features with a missing bin, equal (pure) best scores: '>' wins
    on feature 0, '<=' on feature 1.  The flat op-major argmax picks
    (feat 1, LE); the per-feature rule picks (feat 0, GT)."""
    h = np.zeros((1, 2, 3, 2), np.float32)
    h[0, 0] = [(0, 2), (4, 0), (0, 2)]     # bins 0, 1, missing
    h[0, 1] = [(4, 0), (0, 2), (0, 2)]
    return h, np.array([2, 2], np.int32), np.zeros(2, np.int32)


def _decisions_equal(got, want, stats=True):
    for f in ("score", "feat", "bin", "op") + (("pos_stats", "neg_stats")
                                               if stats else ()):
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        if f == "score":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("heur", ["info_gain", "gini", "chi_square"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("min_leaf", [1, 4])
def test_best_splits_matches_reference(heur, seed, min_leaf):
    hist, n_num, n_cat = _hist(seed)
    want = js.best_splits(jnp.asarray(hist), jnp.asarray(n_num),
                          jnp.asarray(n_cat), heuristic=heur, min_leaf=min_leaf)
    got = ts.best_splits(torch.from_numpy(hist), torch.from_numpy(n_num),
                         torch.from_numpy(n_cat), heuristic=heur,
                         min_leaf=min_leaf)
    _decisions_equal(got, want)


@pytest.mark.parametrize("heur", ["info_gain", "gini"])
def test_best_splits_kernel_matches_reference(heur):
    hist, n_num, n_cat = _hist(3, s=3, k=3, b=7)
    want = js.best_splits_kernel(jnp.asarray(hist), jnp.asarray(n_num),
                                 jnp.asarray(n_cat), heuristic=heur)
    got = ts.best_splits_kernel(torch.from_numpy(hist), torch.from_numpy(n_num),
                                torch.from_numpy(n_cat), heuristic=heur)
    _decisions_equal(got, want)


def test_cross_feature_tie_rules_stay_apart():
    hist, n_num, n_cat = _tie_hist()
    args_j = (jnp.asarray(hist), jnp.asarray(n_num), jnp.asarray(n_cat))
    args_t = (torch.from_numpy(hist), torch.from_numpy(n_num),
              torch.from_numpy(n_cat))
    flat_j, flat_t = js.best_splits(*args_j), ts.best_splits(*args_t)
    kern_j, kern_t = js.best_splits_kernel(*args_j), ts.best_splits_kernel(*args_t)
    _decisions_equal(flat_t, flat_j)
    _decisions_equal(kern_t, kern_j)
    assert (int(flat_t.feat[0]), int(flat_t.op[0])) == (1, ts.OP_LE)
    assert (int(kern_t.feat[0]), int(kern_t.op[0])) == (0, ts.OP_GT)


def test_evaluate_predicate_table3():
    rng = np.random.default_rng(4)
    xbin = rng.integers(0, 12, size=200).astype(np.int32)
    n_num = rng.integers(0, 12, size=200).astype(np.int32)
    op = rng.integers(0, 3, size=200).astype(np.int32)
    tbin = rng.integers(0, 12, size=200).astype(np.int32)
    want = np.asarray(js.evaluate_predicate(*map(jnp.asarray,
                                                 (xbin, n_num, op, tbin))))
    got = ts.evaluate_predicate(*map(torch.from_numpy,
                                     (xbin, n_num, op, tbin))).numpy()
    np.testing.assert_array_equal(got, want)
    assert ts.NEG_INF == js.NEG_INF and (ts.OP_LE, ts.OP_GT, ts.OP_EQ) == (0, 1, 2)
