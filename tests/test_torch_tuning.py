"""Port parity for Training-Only-Once Tuning (repro_torch.core.tuning), the
O(M*N) generic selection baseline and the serve-byte model, on the CPU
against the JAX package.

A tree grown by the JAX package is carried across with ``tree_from_numpy``,
so both packages price the SAME tree: classification grids, node counts,
byte grids, fronts and best cells are equal exactly (integer correct
counts); regression grids sum squared error in f32 in another order and
are held to rtol 1e-5.  The port-only tests mirror the reference's
retrain-oracle contracts on trees the port grows itself."""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import (GossConfig as JGoss, GradientBoostedTrees as JGBT,
                        SweepSpace as JSpace, TreeConfig as JConfig,
                        build_tree as jbuild, fit_bins, transform)
from repro.core import tuning as jtuning
from repro.core.generic import generic_best_split_on_feature as jgeneric
from repro.data import (make_classification, make_regression,
                        train_val_test_split)
from repro.serve import pack as jpack
from repro_torch.core import (GossConfig, GradientBoostedTrees, SweepSpace,
                              TreeConfig, build_tree, predict_bins,
                              prune_stats, sweep, tune)
from repro_torch.core import tuning as ttuning
from repro_torch.core.binning import BinnedTable
from repro_torch.core.generic import generic_best_split_on_feature
from repro_torch.core.tree import tree_from_numpy
from repro_torch.serve import pack as tpack

CPU = "cpu"
SPACE_3AX = dict(dmax_values=(3, 8, 64), smin_values=(0, 5, 25, 60),
                 mcw_values=(0.0, 4.0, 20.0))


def _carry(tree):
    return tree_from_numpy(tree._asdict(), tree.n_nodes)


def _port_table(table):
    return BinnedTable(bins=np.asarray(table.bins), n_num=np.asarray(table.n_num),
                       n_cat=np.asarray(table.n_cat), metas=[],
                       n_bins=int(table.n_bins))


@pytest.fixture(scope="module")
def setup():
    """The reference's TOOT fixture: a full classification tree."""
    cols, y = make_classification(3000, 8, 3, seed=7, n_cat_features=2)
    (tr_c, tr_y), (va_c, va_y), _ = train_val_test_split(cols, y)
    table = fit_bins(tr_c, max_num_bins=64)
    full = jbuild(table, tr_y, JConfig(max_depth=64), n_classes=3)
    vb = transform(va_c, table)
    return table, full, tr_y, vb, va_y


def _same_sweep(got, want, exact=True):
    for f in ("dmax", "smin", "mcw"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    if exact:
        np.testing.assert_array_equal(got.metric, want.metric)
        assert got.front == want.front
        assert got.best == want.best
    else:
        np.testing.assert_allclose(got.metric, want.metric, rtol=1e-5)
    np.testing.assert_array_equal(got.n_nodes, want.n_nodes)
    np.testing.assert_array_equal(got.walk_bytes, want.walk_bytes)
    assert got.n_configs == want.n_configs


# ---------------------------------------------------------------------------
# the same tree priced by both packages
# ---------------------------------------------------------------------------

def test_path_tables_equal(setup):
    table, full, tr_y, vb, va_y = setup
    want = jtuning.path_tables(full, vb, table.n_num)
    got = ttuning.path_tables(_carry(full), vb, table.n_num, device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("space", [SPACE_3AX, dict(mcw_values=(0.0, 6.0))],
                         ids=["3axis", "paper_axes"])
def test_sweep_tree_equal(setup, space):
    table, full, tr_y, vb, va_y = setup
    want = jtuning.sweep(full, vb, va_y, table.n_num, space=JSpace(**space),
                         train_size=len(tr_y))
    got = sweep(_carry(full), vb, va_y, table.n_num,
                space=SweepSpace(**space), train_size=len(tr_y), device=CPU)
    _same_sweep(got, want)


def test_toot_grid_tune_prune_stats_equal(setup):
    table, full, tr_y, vb, va_y = setup
    carried = _carry(full)
    want = jtuning.tune(full, vb, va_y, table.n_num, train_size=len(tr_y))
    got = tune(carried, vb, va_y, table.n_num, train_size=len(tr_y),
               device=CPU)
    np.testing.assert_array_equal(got.grid.metric, want.grid.metric)
    np.testing.assert_array_equal(got.grid.dmax, want.grid.dmax)
    np.testing.assert_array_equal(got.grid.smin, want.grid.smin)
    assert (got.best_dmax, got.best_smin, got.best_metric, got.n_configs,
            got.best_nodes) == (want.best_dmax, want.best_smin,
                                want.best_metric, want.n_configs,
                                want.best_nodes)
    grid = ttuning.toot_grid(carried, vb, va_y, table.n_num,
                             dmax_values=(2, 5), smin_values=(0, 9, 40),
                             train_size=len(tr_y), device=CPU)
    jgrid = jtuning.toot_grid(full, vb, va_y, table.n_num,
                              dmax_values=(2, 5), smin_values=(0, 9, 40),
                              train_size=len(tr_y))
    np.testing.assert_array_equal(grid.metric, jgrid.metric)
    for d, s, w in [(3, 0, 0.0), (6, 25, 4.0), (64, 2, 20.0), (1, 0, 0.0)]:
        assert prune_stats(carried, d, s, w) == jtuning.prune_stats(full, d, s, w)


def test_sweep_regression_tree_within_tolerance():
    cols, y = make_regression(2000, 6, seed=3)
    (tr_c, tr_y), (va_c, va_y), _ = train_val_test_split(cols, y)
    table = fit_bins(tr_c, max_num_bins=64)
    tree = jbuild(table, tr_y, JConfig(max_depth=32, task="regression"))
    vb = transform(va_c, table)
    space = dict(dmax_values=(2, 6, 32), smin_values=(0, 10, 50))
    want = jtuning.sweep(tree, vb, va_y, table.n_num, space=JSpace(**space),
                         train_size=len(tr_y), classification=False)
    got = sweep(_carry(tree), vb, va_y, table.n_num, space=SweepSpace(**space),
                train_size=len(tr_y), classification=False, device=CPU)
    _same_sweep(got, want, exact=False)


# ---------------------------------------------------------------------------
# port-only mirrors of the reference's contracts (tests/test_tuning.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_setup(setup):
    table, _, tr_y, vb, va_y = setup
    ptable = _port_table(table)
    full = build_tree(ptable, tr_y, TreeConfig(max_depth=64), n_classes=3,
                      device=CPU)
    return ptable, full, tr_y, vb, va_y


def test_toot_equals_retrain(port_setup):
    table, full, tr_y, vb, va_y = port_setup
    for dmax, smin in [(3, 0), (6, 25), (10, 50), (full.max_tree_depth, 2)]:
        p_once = predict_bins(full, vb, table.n_num, max_depth=dmax,
                              min_samples_split=max(smin, 2), device=CPU)
        retrained = build_tree(
            table, tr_y,
            TreeConfig(max_depth=dmax, min_samples_split=max(smin, 2)),
            n_classes=3, device=CPU)
        assert torch.equal(p_once, predict_bins(retrained, vb, table.n_num,
                                                device=CPU))


def test_sweep_matches_retrain_oracle_3axis(port_setup):
    table, full, tr_y, vb, va_y = port_setup
    res = sweep(full, vb, va_y, table.n_num, space=SweepSpace(**SPACE_3AX),
                train_size=len(tr_y), device=CPU)
    assert res.metric.shape == (3, 4, 3) and res.n_configs == 36
    for i, d in enumerate(SPACE_3AX["dmax_values"]):
        for j, s in enumerate(SPACE_3AX["smin_values"]):
            for k, w in enumerate(SPACE_3AX["mcw_values"]):
                rt = build_tree(table, tr_y,
                                TreeConfig(max_depth=d, min_samples_split=s,
                                           min_child_weight=w),
                                n_classes=3, device=CPU)
                acc = (predict_bins(rt, vb, table.n_num, device=CPU).numpy()
                       == va_y).mean()
                assert res.metric[i, j, k] == acc, (d, s, w)
                assert res.n_nodes[i, j, k] == prune_stats(full, d, s, w)[0]


def test_sweep_ensemble_n_rounds_prefix_matches_retrain():
    """The first r trees of one port fit are the r-round refit, and the
    sweep's raw-score carry is the fit's update: every (r, dmax, smin, mcw)
    cell equals refitting with n_trees = r and serving the pruning axes as
    runtime hyper-parameters."""
    cols, y = make_classification(1500, 6, 2, seed=5, n_cat_features=1)
    (tr_c, tr_y), (va_c, va_y), _ = train_val_test_split(cols, y)
    table = fit_bins(tr_c, max_num_bins=32)
    ptable = _port_table(table)
    vb = transform(va_c, table)
    lr = 0.3

    def mk(r):
        return GradientBoostedTrees(
            n_trees=r, learning_rate=lr,
            config=TreeConfig(max_depth=5, task="regression_variance"),
            loss="logistic", seed=0, goss=GossConfig(0.3, 0.2))

    ens = mk(5).fit(ptable, tr_y, device=CPU)
    space = SweepSpace(dmax_values=(2, 5), smin_values=(0, 30),
                       mcw_values=(0.0, 4.0), n_rounds_values=(1, 3, 5))
    res = ens.sweep(vb, va_y, space=space, train_size=len(tr_y))
    assert res.metric.shape == (3, 2, 2, 2)
    lr_t = torch.tensor(lr, dtype=torch.float32)
    for ri, r in enumerate(space.n_rounds_values):
        refit = mk(r).fit(ptable, tr_y, device=CPU)
        for t_ref, t_all in zip(refit.trees, ens.trees):
            assert torch.equal(t_ref.feat, t_all.feat)
            assert torch.equal(t_ref.label, t_all.label)
        for i, d in enumerate(space.dmax_values):
            for j, s in enumerate(space.smin_values):
                for k, w in enumerate(space.mcw_values):
                    raw = torch.full((len(va_y),), refit.base)
                    for t in refit.trees:          # fit-order accumulation
                        raw = raw + lr_t * predict_bins(
                            t, vb, table.n_num, max_depth=d,
                            min_samples_split=s, min_child_weight=w,
                            num_steps=5, device=CPU)
                    acc = ((raw > 0).int().numpy() == va_y).mean()
                    assert res.metric[ri, i, j, k] == acc, (r, d, s, w)
    for ri, r in enumerate(space.n_rounds_values):
        for i, d in enumerate(space.dmax_values):
            pn = sum(prune_stats(t, d, 0, 0.0)[0] for t in ens.trees[:r])
            assert res.n_nodes[ri, i, 0, 0] == pn


def test_tune_breaks_metric_ties_toward_cheapest(port_setup):
    table, full, tr_y, vb, va_y = port_setup
    res = tune(full, vb, va_y, table.n_num, train_size=len(tr_y), device=CPU)
    grid = res.grid
    best = grid.metric.max()
    assert res.best_metric == best
    ties = np.argwhere(grid.metric == best)
    assert len(ties) >= 2, "fixture regression: grid should have flat ties"
    tie_nodes = [prune_stats(full, int(grid.dmax[i]), int(grid.smin[j]))[0]
                 for i, j in ties]
    assert res.best_nodes == min(tie_nodes)
    assert prune_stats(full, res.best_dmax, res.best_smin)[0] == res.best_nodes


@pytest.mark.parametrize("seed", range(4))
def test_pareto_front_property_non_dominated(seed):
    """Seeded random grids: the front is mutually non-dominated, free of
    duplicate triples, and weakly dominates every input point; it equals
    the reference's front."""
    rng = np.random.default_rng(seed)
    for _ in range(15):
        n = int(rng.integers(1, 41))
        m = rng.integers(0, 9, n).astype(np.float64)
        nodes = rng.integers(1, 10, n)
        wb = rng.integers(1, 10, n)
        configs = [{"i": k} for k in range(n)]
        front = ttuning.pareto_front(m, nodes, wb, configs)
        assert front == jtuning.pareto_front(m, nodes, wb, configs)
        trip = [(f.metric, f.n_nodes, f.walk_bytes) for f in front]
        assert len(set(trip)) == len(trip)
        for a in trip:
            assert not any(x != a and x[0] >= a[0] and x[1] <= a[1]
                           and x[2] <= a[2] for x in trip)
        for k in range(n):
            assert any(t[0] >= m[k] and t[1] <= nodes[k] and t[2] <= wb[k]
                       for t in trip)


# ---------------------------------------------------------------------------
# the baseline selection and the serve-byte model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heuristic", ["info_gain", "gini", "chi_square"])
@pytest.mark.parametrize("seed", [0, 1])
def test_generic_best_split_equal(heuristic, seed):
    rng = np.random.default_rng(seed)
    values = [float(v) for v in rng.integers(0, 12, 150)] + ["a", "b"] * 10
    labels = rng.integers(0, 3, len(values))
    table = fit_bins([values], max_num_bins=64)
    args = (table.bins[:, 0], labels.astype(np.int32))
    want = jgeneric(jnp.asarray(args[0]), jnp.asarray(args[1]),
                    jnp.int32(table.n_num[0]), jnp.int32(table.n_cat[0]),
                    n_classes=3, n_bins=table.n_bins, heuristic=heuristic,
                    min_leaf=2)
    got = generic_best_split_on_feature(
        *args, table.n_num[0], table.n_cat[0], n_classes=3,
        n_bins=table.n_bins, heuristic=heuristic, min_leaf=2, device=CPU)
    assert (int(got[1]), int(got[2])) == (int(want[1]), int(want[2]))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)


def test_record_and_walk_bytes_equal():
    for n_feat, n_bins, loff in [(1, 1, 0), (41, 257, 3), (128, 128, 127),
                                 (129, 32768, 128), (40000, 32769, 70000)]:
        assert (tpack.predict_record_bytes(n_feat, n_bins, loff)
                == jpack.predict_record_bytes(n_feat, n_bins, loff))
    steps = np.arange(1, 9)[:, None]
    np.testing.assert_array_equal(
        tpack.walk_bytes_per_request(np.arange(1, 4), steps, 6),
        jpack.walk_bytes_per_request(np.arange(1, 4), steps, 6))
    assert (tpack.FAT_STEP_BYTES, tpack.LABEL_BYTES) == (jpack.FAT_STEP_BYTES,
                                                         jpack.LABEL_BYTES)


def test_ensemble_sweep_of_a_reference_fit_equal():
    """A JAX-fitted logistic GOSS ensemble carried across prices the same
    ensemble sweep in both packages."""
    from repro_torch.core import ensemble_from_numpy
    cols, y = make_classification(1200, 6, 2, seed=11, n_cat_features=1)
    (tr_c, tr_y), (va_c, va_y), _ = train_val_test_split(cols, y)
    table = fit_bins(tr_c, max_num_bins=32)
    vb = transform(va_c, table)
    cfg = dict(max_depth=4, task="regression_variance")
    ref = JGBT(n_trees=4, learning_rate=0.3, config=JConfig(**cfg),
               loss="logistic", seed=0, goss=JGoss(0.2, 0.2)).fit(table, tr_y)
    ens = ensemble_from_numpy([t._asdict() for t in ref.trees], base=ref.base,
                              learning_rate=0.3, loss="logistic",
                              n_num=ref.n_num, config=TreeConfig(**cfg),
                              device=CPU)
    space = dict(dmax_values=(2, 4), smin_values=(0, 20),
                 mcw_values=(0.0, 4.0))
    want = ref.sweep(vb, va_y, space=JSpace(**space), train_size=len(tr_y))
    got = ens.sweep(vb, va_y, space=SweepSpace(**space), train_size=len(tr_y))
    _same_sweep(got, want)
    np.testing.assert_array_equal(got.n_rounds, want.n_rounds)
    np.testing.assert_allclose(ens.predict_raw(vb), ref.predict_raw(vb),
                               rtol=1e-6, atol=1e-6)
