"""Port parity for Newton / GOSS boosting (repro_torch.core.forest) on the
CPU against repro.core.forest.

The GOSS top set is RNG-free and must equal ``jax.lax.top_k``'s, ties
included.  The uniform remainder comes from a torch generator, which cannot
draw the reference's threefry bits, so the fit parity tests record the
reference's draws and feed them to the port by replacing
``repro_torch.core.forest._goss_sample``.  Integer-valued targets under
integer weights give field-equal trees (every histogram sum is exact);
float targets are held to the reference's float contract, predictions
within rtol/atol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import (GossConfig as JGoss, GradientBoostedTrees as JGBT,
                        TreeConfig as JConfig, fit_bins, transform)
from repro.core import forest as jforest
from repro.data import make_classification, train_val_test_split
from repro_torch.core import (GossConfig, GradientBoostedTrees, TreeConfig,
                              forest as tforest)
from repro_torch.core.binning import BinnedTable

CPU = "cpu"
EXACT = ("feat", "op", "tbin", "label", "count", "depth", "left", "right",
         "leaf", "parent")


def _port_table(table):
    return BinnedTable(bins=np.asarray(table.bins), n_num=np.asarray(table.n_num),
                       n_cat=np.asarray(table.n_cat), metas=[],
                       n_bins=int(table.n_bins))


@pytest.mark.parametrize("a,b", [(0.2, 0.1), (0.0, 0.5), (0.9, 0.1),
                                 (0.3, 0.7), (0.5, 0.25)])
def test_goss_config_sizes_equal(a, b):
    j, t = JGoss(a, b), GossConfig(a, b)
    assert t.amplification == j.amplification
    for m in (1, 2, 7, 100, 1001, 494021):
        assert t.sample_sizes(m) == j.sample_sizes(m)


@pytest.mark.parametrize("a,b", [(1.0, 0.1), (-0.1, 0.1), (0.5, 0.0),
                                 (0.5, 0.6)])
def test_goss_config_rejects_like_the_reference(a, b):
    with pytest.raises(ValueError):
        JGoss(a, b)
    with pytest.raises(ValueError):
        GossConfig(a, b)


def test_goss_top_set_equals_lax_top_k_on_round0_ties():
    """Logistic round 0: raw is the constant base score, so g takes two
    values and the leverage ranking is one mass tie per class."""
    cols, y = make_classification(2000, 4, 2, seed=1)
    y = y.astype(np.float32)
    lo = tforest.get_loss("logistic")
    yt = torch.from_numpy(y)
    g, h = lo.grad_hess(yt, lo.base_score(yt).expand(len(y)))
    rank = g * torch.sqrt(h)
    assert len(torch.unique(rank.abs())) == 2
    for top_n in (1, 399, 400, 1500):
        want = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(rank.numpy())),
                                        top_n)[1])
        np.testing.assert_array_equal(
            tforest._top_indices(rank.abs(), top_n).numpy(), want)
    gen = torch.Generator().manual_seed(0)
    idx, w = tforest._goss_sample(rank, gen, top_n=400, other_n=200, amp=4.0)
    want = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(rank.numpy())), 400)[1])
    np.testing.assert_array_equal(idx[:400].numpy(), want)
    assert len(set(idx.tolist())) == 600
    assert w[:400].eq(1.0).all() and w[400:].eq(4.0).all()


def _recorded_fit(monkeypatch, ref, table, y):
    """Fit the reference, recording every GOSS draw it makes."""
    draws = []
    orig = jforest._goss_sample

    def record(*args, **kw):
        idx, w = orig(*args, **kw)
        draws.append((np.asarray(idx), np.asarray(w)))
        return idx, w

    monkeypatch.setattr(jforest, "_goss_sample", record)
    ref.fit(table, y)
    return draws


def _fed_fit(monkeypatch, ens, table, y, draws):
    """Fit the port with the reference's draws in place of its own."""
    it = iter(draws)

    def replay(rank, gen, **kw):
        idx, w = next(it)
        return torch.tensor(idx).long(), torch.tensor(w)

    monkeypatch.setattr(tforest, "_goss_sample", replay)
    ens.fit(_port_table(table), y, device=CPU)
    assert next(it, None) is None
    return ens


@pytest.mark.parametrize("goss,seed", [((0.2, 0.2), 0), ((0.3, 0.1), 1),
                                       ((0.0, 0.5), 2)])
def test_fit_fed_reference_draws_integer_targets_field_equal(monkeypatch,
                                                             goss, seed):
    """Squared loss on integer targets whose mean is 0: z = y is an
    integer, every GOSS weight (1 and (1-a)/b) an integer, so both trees
    sum exact histograms and must be equal field for field."""
    cols, c = make_classification(1600, 6, 3, seed=seed, n_cat_features=1)
    keep = np.concatenate([np.flatnonzero(c == 1),
                           *(np.flatnonzero(c == k)[:min((c == 0).sum(),
                                                         (c == 2).sum())]
                             for k in (0, 2))])
    y = (c[np.sort(keep)] - 1).astype(np.float32)
    assert y.sum() == 0
    table = fit_bins([list(np.asarray(col, dtype=object)[np.sort(keep)])
                      for col in cols], max_num_bins=32)
    cfg = dict(max_depth=6, task="regression_variance")
    ref = JGBT(n_trees=1, learning_rate=0.5, config=JConfig(**cfg),
               loss="squared", seed=seed, goss=JGoss(*goss))
    draws = _recorded_fit(monkeypatch, ref, table, y)
    ens = _fed_fit(monkeypatch, GradientBoostedTrees(
        n_trees=1, learning_rate=0.5, config=TreeConfig(**cfg),
        loss="squared", seed=seed, goss=GossConfig(*goss)), table, y, draws)
    got, want = ens.trees[0], ref.trees[0]
    assert got.n_nodes == want.n_nodes > 3
    n = want.n_nodes
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy()[:n],
                                      np.asarray(getattr(want, f))[:n],
                                      err_msg=f)
    np.testing.assert_allclose(got.score.numpy()[:n],
                               np.asarray(want.score)[:n], rtol=1e-6)
    assert ens.base == ref.base


@pytest.mark.parametrize("loss,goss", [("logistic", (0.3, 0.2)),
                                       ("logistic", None),
                                       ("squared", (0.2, 0.2))])
def test_fit_fed_reference_draws_float_targets_predict_close(monkeypatch,
                                                             loss, goss):
    cols, y = make_classification(1500, 6, 2, seed=5, n_cat_features=1)
    (tr_c, tr_y), (va_c, va_y), _ = train_val_test_split(cols, y)
    table = fit_bins(tr_c, max_num_bins=32)
    vb = transform(va_c, table)
    y_fit = tr_y.astype(np.float32)
    cfg = dict(max_depth=5, task="regression_variance")
    kw = dict(n_trees=4, learning_rate=0.3, loss=loss, seed=3)
    ref = JGBT(config=JConfig(**cfg), goss=goss and JGoss(*goss), **kw)
    draws = _recorded_fit(monkeypatch, ref, table, y_fit)
    ens = _fed_fit(monkeypatch, GradientBoostedTrees(
        config=TreeConfig(**cfg), goss=goss and GossConfig(*goss), **kw),
        table, y_fit, draws)
    np.testing.assert_allclose(ens.predict_raw(vb), ref.predict_raw(vb),
                               rtol=1e-4, atol=1e-4)
    if loss == "logistic":
        np.testing.assert_array_equal(ens.predict(vb), ref.predict(vb))
        np.testing.assert_allclose(ens.predict_proba(vb),
                                   ref.predict_proba(vb), rtol=1e-4,
                                   atol=1e-4)


def test_fit_is_deterministic_and_round_prefixes_refit():
    cols, y = make_classification(1200, 5, 2, seed=2)
    table = _port_table(fit_bins(cols, max_num_bins=32))

    def fit(r):
        return GradientBoostedTrees(
            n_trees=r, learning_rate=0.3, loss="logistic", seed=7,
            goss=GossConfig(0.2, 0.3)).fit(table, y.astype(np.float32),
                                           device=CPU)

    a, b, two = fit(4), fit(4), fit(2)
    for ta, tb in zip(a.trees, b.trees):
        for f in EXACT + ("score",):
            assert torch.equal(getattr(ta, f), getattr(tb, f)), f
    for ta, t2 in zip(a.trees, two.trees):
        assert ta.n_nodes == t2.n_nodes
        assert torch.equal(ta.label, t2.label)


def test_fit_surface_rejects_what_the_port_lacks():
    cols, y = make_classification(300, 4, 3, seed=0)
    table = _port_table(fit_bins(cols, max_num_bins=16))
    # the mesh-sharded fit is not ported: its arguments do not exist
    with pytest.raises(TypeError, match="mesh"):
        GradientBoostedTrees(loss="softmax").fit(table, y, mesh=object(),
                                                 device=CPU)
    with pytest.raises(ValueError, match="non-finite labels"):
        GradientBoostedTrees().fit(table, np.full(300, np.nan), device=CPU)
    with pytest.raises(ValueError, match="sample_weight"):
        GradientBoostedTrees().fit(table, y.astype(np.float32),
                                   sample_weight=-np.ones(300), device=CPU)
    ens = GradientBoostedTrees(n_trees=2).fit(table, y.astype(np.float32),
                                              device=CPU)
    with pytest.raises(ValueError, match="regression objective"):
        ens.predict_proba(table.bins)
    tables, n_num, meta = ens.export_stacked()
    assert tables["feat"].shape[0] == 2 and meta["link_id"] == 0
