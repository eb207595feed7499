"""Offline tabular data pipeline (numpy), the port's copy of
``repro.data.synthetic``.

The paper's UCI/Kaggle tables are not bundled with the repository, so they
are replaced by synthetic generators shaped like them (same M, K, C, and a mix
of numeric / categorical / hybrid / missing columns).  Ground truth is a
random decision-tree teacher plus label noise, so learned trees have the
same qualitative structure (recoverable splits, tunable depth) as the paper's
benchmarks.  `DATASET_ZOO` mirrors the paper's Table 6/7 dataset roster at
reduced scale (CI-friendly sizes; benchmarks scale them up via `scale=`).
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_classification", "make_regression", "make_hybrid_table",
           "train_val_test_split", "DATASET_ZOO", "make_dataset"]


def _teacher_tree(rng, x, depth):
    """Label M x K numeric features with a random axis-aligned tree.
    Returns the leaf index (0 .. 2^depth-1) of each example."""
    m = x.shape[0]
    leaf_of = np.zeros(m, dtype=np.int64)
    for d in range(depth):
        feats = rng.integers(0, x.shape[1], size=1 << d)
        nxt = 2 * leaf_of  # default: left
        for leaf in range(1 << d):
            sel = leaf_of == leaf
            if sel.sum() < 8:
                continue
            f = feats[leaf]
            thr = np.quantile(x[sel, f], rng.uniform(0.25, 0.75))
            nxt[sel] = 2 * leaf + (x[sel, f] > thr).astype(np.int64)
        leaf_of = nxt
    return leaf_of


def make_classification(m, k, c, *, seed=0, teacher_depth=6, noise=0.05,
                        n_cat_features=0, cat_cardinality=8, missing_frac=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k))
    leaves = _teacher_tree(rng, x, teacher_depth)
    leaf_label = rng.integers(0, c, size=int(leaves.max()) + 1)
    y = leaf_label[leaves]
    flip = rng.uniform(size=m) < noise
    y = np.where(flip, rng.integers(0, c, size=m), y).astype(np.int32)

    cols = []
    for j in range(k):
        if j < n_cat_features:
            # categorical column derived from quantised numeric (so it is
            # predictive) with string categories
            q = np.clip((x[:, j] * 2 + cat_cardinality / 2).astype(int),
                        0, cat_cardinality - 1)
            col = np.array([f"cat_{v}" for v in q], dtype=object)
        else:
            col = x[:, j].astype(object)
        if missing_frac:
            miss = rng.uniform(size=m) < missing_frac
            col = col.copy()
            col[miss] = None
        cols.append(list(col))
    return cols, y


def make_regression(m, k, *, seed=0, teacher_depth=6, noise=0.1,
                    n_cat_features=0, missing_frac=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k))
    leaves = _teacher_tree(rng, x, teacher_depth)
    leaf_val = rng.normal(size=int(leaves.max()) + 1) * 10
    y = (leaf_val[leaves] + rng.normal(size=m) * noise).astype(np.float32)
    cols = []
    for j in range(k):
        if j < n_cat_features:
            q = np.clip((x[:, j] * 2 + 4).astype(int), 0, 7)
            col = np.array([f"c{v}" for v in q], dtype=object)
        else:
            col = x[:, j].astype(object)
        if missing_frac:
            miss = rng.uniform(size=m) < missing_frac
            col = col.copy()
            col[miss] = None
        cols.append(list(col))
    return cols, y


def make_hybrid_table(m, *, seed=0):
    """A table exercising every hybrid-feature corner: mixed numeric+string
    values in ONE column, unparseable numerics, None/NaN missing."""
    rng = np.random.default_rng(seed)
    mixed = [float(rng.normal()) if rng.uniform() < 0.5
             else ("red" if rng.uniform() < 0.5 else "blue") for _ in range(m)]
    stringy_nums = [str(round(float(rng.normal()), 3)) if rng.uniform() < 0.8
                    else "N/A" for _ in range(m)]
    with_missing = [None if rng.uniform() < 0.15 else float(rng.normal())
                    for _ in range(m)]
    pure_cat = [rng.choice(["a", "b", "c", "d"]) for _ in range(m)]
    y = np.asarray([(1 if (isinstance(v, float) and v > 0) or v == "red" else 0)
                    for v in mixed], dtype=np.int32)
    return [mixed, stringy_nums, with_missing, pure_cat], y


def train_val_test_split(cols, y, *, seed=0, val=0.1, test=0.1):
    m = len(y)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m)
    n_test = int(m * test)
    n_val = int(m * val)
    te, va, tr = perm[:n_test], perm[n_test:n_test + n_val], perm[n_test + n_val:]

    def take(idx):
        return [list(np.asarray(c, dtype=object)[idx]) for c in cols], y[idx]

    return take(tr), take(va), take(te)


# paper Table 6/7 roster, re-scaled for offline synthetic reproduction
# name: (m, k, c_or_None, n_cat_features, missing_frac)
DATASET_ZOO = {
    "adult":            (32561, 14, 2, 6, 0.01),
    "credit_card":      (30000, 23, 2, 3, 0.0),
    "shuttle":          (20000, 9, 7, 0, 0.0),
    "nursery":          (12960, 8, 5, 8, 0.0),
    "letter":           (20000, 16, 26, 0, 0.0),
    "churn_modeling":   (10000, 10, 2, 2, 0.0),
    "kdd99_10pct":      (49402, 41, 23, 7, 0.0),
    "credit_card_fraud": (100000, 7, 2, 0, 0.0),
    # regression (c is None)
    "bike_sharing":     (17379, 12, None, 2, 0.0),
    "california_housing": (20640, 9, None, 0, 0.005),
    "wine_quality":     (6497, 11, None, 0, 0.0),
}


def make_dataset(name, *, scale=1.0, seed=0):
    m, k, c, ncat, miss = DATASET_ZOO[name]
    m = int(m * scale)
    # teacher depth scales with m so every leaf region stays estimable
    # (~200 examples/leaf) regardless of the benchmark's --scale
    depth = max(3, min(10, int(np.log2(max(m, 64) / 200))))
    if c is None:
        cols, y = make_regression(m, k, seed=seed, n_cat_features=ncat,
                                  missing_frac=miss, teacher_depth=depth)
        return cols, y, None
    cols, y = make_classification(m, k, c, seed=seed, n_cat_features=ncat,
                                  missing_frac=miss, teacher_depth=depth)
    return cols, y, c
