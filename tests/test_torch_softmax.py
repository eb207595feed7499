"""Port parity for softmax (multiclass) Newton boosting on the CPU against
repro.core.forest: the raw [M, C] scores within rtol/atol 1e-4 (the
reference's float contract: the two packages round the float moment sums
differently), equal class ids wherever the top two logits are more than
1e-3 apart, and the reference's predict / export / loss surface.

The GOSS remainder comes from a torch generator, which cannot draw the
reference's threefry bits, so the GOSS fit records the reference's draws
and feeds them to the port by replacing ``_goss_sample``."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import (GossConfig as JGoss, GradientBoostedTrees as JGBT,
                        TreeConfig as JConfig, fit_bins)
from repro.core import forest as jforest
from repro.core.losses import SoftmaxLoss as JSoftmax
from repro.data import make_classification
from repro_torch.core import (GossConfig, GradientBoostedTrees, SoftmaxLoss,
                              SweepSpace, TreeConfig, ensemble_from_numpy,
                              forest as tforest)
from repro_torch.core.binning import BinnedTable

CPU = "cpu"
CFG = dict(max_depth=4, task="regression_variance")


@pytest.fixture(scope="module")
def problem():
    cols, y = make_classification(1200, 6, 4, seed=3, n_cat_features=1)
    table = fit_bins(cols, max_num_bins=32)
    port = BinnedTable(bins=np.asarray(table.bins),
                       n_num=np.asarray(table.n_num),
                       n_cat=np.asarray(table.n_cat), metas=[],
                       n_bins=int(table.n_bins))
    return table, port, y


def _recorded_fit(monkeypatch, ref, table, y, **kw):
    draws = []
    orig = jforest._goss_sample

    def record(*args, **kw):
        idx, w = orig(*args, **kw)
        draws.append((np.asarray(idx), np.asarray(w)))
        return idx, w

    monkeypatch.setattr(jforest, "_goss_sample", record)
    ref.fit(table, y, **kw)
    return draws


def _fed_fit(monkeypatch, ens, table, y, draws, **kw):
    it = iter(draws)

    def replay(rank, gen, **kw):
        idx, w = next(it)
        return torch.tensor(idx).long(), torch.tensor(w)

    monkeypatch.setattr(tforest, "_goss_sample", replay)
    ens.fit(table, y, device=CPU, **kw)
    assert next(it, None) is None
    return ens


def _assert_scores_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(1)[clear], want.argmax(1)[clear])


@pytest.mark.parametrize("goss,weighted", [(None, False), (None, True),
                                            ((0.3, 0.2), True)])
def test_softmax_fit_matches_reference(monkeypatch, problem, goss, weighted):
    """Under GOSS the fit carries random sample weights: at round 0 every
    class's targets and hessians take two values and the GOSS weights two
    more, so distinct splits with the same row counts tie in exact
    arithmetic, and each package's float rounding picks among them (the
    reference's float contract does not cover a tie).  Generic weights
    leave no exact ties."""
    table, port, y = problem
    sw = (np.random.default_rng(7).uniform(0.5, 1.5, len(y)).astype(np.float32)
          if weighted else None)
    ref = JGBT(n_trees=2, learning_rate=0.3, config=JConfig(**CFG),
               loss="softmax", seed=4,
               goss=None if goss is None else JGoss(*goss))
    ens = GradientBoostedTrees(n_trees=2, learning_rate=0.3,
                               config=TreeConfig(**CFG), loss="softmax",
                               seed=4,
                               goss=None if goss is None else GossConfig(*goss))
    if goss is None:
        ref.fit(table, y, sample_weight=sw)
        ens.fit(port, y, sample_weight=sw, device=CPU)
    else:
        draws = _recorded_fit(monkeypatch, ref, table, y, sample_weight=sw)
        assert len(draws) == 2
        _fed_fit(monkeypatch, ens, port, y, draws, sample_weight=sw)
    assert len(ens.trees) == len(ref.trees) == 2 * 4
    np.testing.assert_allclose(ens.base, np.asarray(ref.base), rtol=1e-6)
    _assert_scores_close(ens.predict_raw(port.bins),
                         np.asarray(ref.predict_raw(table.bins)))


def test_softmax_goss_rank_and_round_weights(monkeypatch, problem):
    """Under GOSS the port ranks rows by sqrt(sum_c g_c^2 h_c) and builds on
    ``w[None] * h[:, idx]`` (the reference's expressions)."""
    _, port, y = problem
    seen = {}
    orig_sample = tforest._goss_sample
    orig_build = tforest.build_trees_batched

    def sample(rank, gen, **kw):
        seen["rank"] = rank.clone()
        out = orig_sample(rank, gen, **kw)
        seen["draw"] = out
        return out

    def build(table, z, config, sample_weight=None, **kw):
        seen["w"] = sample_weight.clone()
        return orig_build(table, z, config, sample_weight=sample_weight, **kw)

    monkeypatch.setattr(tforest, "_goss_sample", sample)
    monkeypatch.setattr(tforest, "build_trees_batched", build)
    ens = GradientBoostedTrees(n_trees=1, config=TreeConfig(**CFG),
                               loss="softmax", goss=GossConfig(0.2, 0.3))
    ens.fit(port, y, device=CPU)
    lo = tforest.get_loss("softmax", n_classes=4)
    yt = torch.from_numpy(y)
    raw = lo.base_score(yt)[:, None].expand(4, len(y))
    g, h = lo.grad_hess(yt, raw)
    assert torch.equal(seen["rank"], torch.sqrt(torch.sum(g * g * h, dim=0)))
    idx, w = seen["draw"]
    assert torch.equal(seen["w"], w[None] * h[:, idx])
    assert seen["w"].shape == (4, 240 + 360)


def test_softmax_predict_triple(problem):
    _, port, y = problem
    ens = GradientBoostedTrees(n_trees=2, config=TreeConfig(**CFG),
                               loss="softmax").fit(port, y, device=CPU)
    raw = ens.predict_raw(port.bins)
    proba = ens.predict_proba(port.bins)
    pred = ens.predict(port.bins)
    assert raw.shape == proba.shape == (len(y), 4)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(pred, raw.argmax(axis=1))
    assert pred.dtype == np.int32
    assert (pred == y).mean() > 0.5
    # round-major: round r's class-c tree at r * C + c
    first = ens.trees[:4]
    again = GradientBoostedTrees(n_trees=1, config=TreeConfig(**CFG),
                                 loss="softmax").fit(port, y, device=CPU)
    for a, b in zip(first, again.trees):
        assert a.n_nodes == b.n_nodes and torch.equal(a.feat, b.feat)


def test_softmax_export_stacked_meta(problem):
    _, port, y = problem
    ens = GradientBoostedTrees(n_trees=2, config=TreeConfig(**CFG),
                               loss="softmax").fit(port, y, device=CPU)
    tables, n_num, meta = ens.export_stacked()
    assert tables["feat"].shape[0] == 2 * 4
    assert meta["n_classes"] == 4 and meta["link_id"] == 2
    assert meta["loss"] == "softmax" and meta["num_steps"] == 4
    assert isinstance(meta["base"], list) and len(meta["base"]) == 4
    np.testing.assert_allclose(meta["base"], ens.base)
    np.testing.assert_array_equal(n_num, port.n_num)


def test_ensemble_from_numpy_of_a_reference_softmax_fit(problem):
    table, port, y = problem
    ref = JGBT(n_trees=2, learning_rate=0.3, config=JConfig(**CFG),
               loss="softmax").fit(table, y)
    ens = ensemble_from_numpy([t._asdict() for t in ref.trees],
                              base=np.array(ref.base), learning_rate=0.3,
                              loss="softmax", n_num=ref.n_num,
                              config=TreeConfig(**CFG), device=CPU)
    np.testing.assert_allclose(ens.predict_raw(port.bins),
                               np.asarray(ref.predict_raw(table.bins)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ens.predict_proba(port.bins),
                               np.asarray(ref.predict_proba(table.bins)),
                               rtol=1e-6, atol=1e-6)
    assert ens.export_stacked()[2]["n_classes"] == 4


def test_softmax_n_classes_inferred_and_pinnable(problem):
    _, port, y = problem
    y3 = np.minimum(y, 2)
    ens = GradientBoostedTrees(n_trees=1, config=TreeConfig(**CFG),
                               loss="softmax").fit(port, y3, device=CPU)
    assert ens._fitted_loss().n_classes == 3 and len(ens.trees) == 3
    pinned = GradientBoostedTrees(n_trees=1, config=TreeConfig(**CFG),
                                  loss=SoftmaxLoss(n_classes=5))
    pinned.fit(port, y3, device=CPU)
    assert len(pinned.trees) == 5
    assert pinned.predict_raw(port.bins).shape == (len(y), 5)
    assert JSoftmax(n_classes=5).n_classes == pinned._fitted_loss().n_classes


def test_both_packages_refuse_the_multiclass_sweep(problem):
    table, port, y = problem
    space = dict(dmax_values=(2, 4), smin_values=(0,), mcw_values=(0.0,))
    ref = JGBT(n_trees=1, config=JConfig(**CFG), loss="softmax").fit(table, y)
    with pytest.raises(NotImplementedError, match="scalar-loss"):
        ref.sweep(table.bins, y, space=jforest_space(space))
    ens = GradientBoostedTrees(n_trees=1, config=TreeConfig(**CFG),
                               loss="softmax").fit(port, y, device=CPU)
    with pytest.raises(NotImplementedError, match="scalar-loss"):
        ens.sweep(port.bins, y, space=SweepSpace(**space))


def jforest_space(space):
    from repro.core import SweepSpace as JSpace
    return JSpace(**space)
