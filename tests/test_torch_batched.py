"""Port parity for the multiclass batched build (repro_torch.core.tree
.build_trees_batched), its class-stacked histogram and walk_class_trees on
the CPU, against repro.core.tree.build_trees_batched.

Integer-valued targets under integer hessian weights make every histogram
sum exact, so the port's trees equal the reference's field for field.  With
float targets the two packages round the moment sums differently; they are
held to the reference's float contract, predictions within rtol/atol 1e-4.
The port's own contract is exact on any input: each batched class-tree
equals a separate ``build_tree`` of that class, field for field."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import TreeConfig as JConfig, fit_bins
from repro.core.predict import WALK_FIELDS, walk_class_trees as jwalk
from repro.core.tree import build_trees_batched as jbatched
from repro.data import make_classification
from repro_torch.core import (TreeConfig, build_tree, build_trees_batched,
                              node_histogram, node_histogram_sibling_fused,
                              node_histogram_sibling_fused_stacked,
                              node_histogram_stacked, walk_class_trees)
from repro_torch.core.binning import BinnedTable
from repro_torch.kernels import ops

CPU = "cpu"
EXACT = ("feat", "op", "tbin", "label", "count", "depth", "left", "right",
         "leaf", "parent")
C = 4


@pytest.fixture(scope="module")
def problem():
    cols, _ = make_classification(1500, 6, 3, seed=3, n_cat_features=1)
    table = fit_bins(cols, max_num_bins=32)
    port = BinnedTable(bins=np.asarray(table.bins),
                       n_num=np.asarray(table.n_num),
                       n_cat=np.asarray(table.n_cat), metas=[],
                       n_bins=int(table.n_bins))
    rng = np.random.default_rng(0)
    m = table.bins.shape[0]
    return dict(table=table, port=port,
                z_int=rng.integers(-3, 4, (C, m)).astype(np.float32),
                h_int=rng.integers(1, 3, (C, m)).astype(np.float32),
                z=rng.normal(size=(C, m)).astype(np.float32),
                h=rng.uniform(0.05, 0.25, (C, m)).astype(np.float32))


def _assert_trees_equal(got, want, score_rtol=0.0):
    n = want.n_nodes
    assert got.n_nodes == n
    for f in EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(got, f))[:n],
                                      np.asarray(getattr(want, f))[:n],
                                      err_msg=f)
    np.testing.assert_allclose(np.asarray(got.score)[:n],
                               np.asarray(want.score)[:n], rtol=score_rtol,
                               atol=0)


@pytest.mark.parametrize("chunk_slots,weighted", [(16, False), (0, True),
                                                  (4, True), (4, False)])
def test_batched_equals_reference_on_exact_inputs(problem, chunk_slots,
                                                  weighted):
    cfg = dict(max_depth=5, task="regression_variance",
               chunk_slots=chunk_slots)
    w = problem["h_int"] if weighted else None
    trees, _ = build_trees_batched(problem["port"], problem["z_int"],
                                   TreeConfig(**cfg), sample_weight=w,
                                   device=CPU)
    want, _ = jbatched(problem["table"], problem["z_int"], JConfig(**cfg),
                       sample_weight=w)
    assert len(trees) == C
    for got, ref in zip(trees, want):
        assert ref.n_nodes > 15
        _assert_trees_equal(got, ref, score_rtol=1e-6)


@pytest.mark.parametrize("chunk_slots", [16, 0])
def test_batched_float_inputs_predict_close_to_reference(problem,
                                                         chunk_slots):
    cfg = dict(max_depth=5, task="regression_variance",
               chunk_slots=chunk_slots)
    _, arrays = build_trees_batched(problem["port"], problem["z"],
                                    TreeConfig(**cfg),
                                    sample_weight=problem["h"], device=CPU)
    _, jarrays = jbatched(problem["table"], problem["z"], JConfig(**cfg),
                          sample_weight=problem["h"])
    got = walk_class_trees(arrays, problem["port"].bins,
                           problem["port"].n_num, num_steps=5).numpy()
    want = np.asarray(jwalk({f: jarrays[f] for f in WALK_FIELDS},
                            problem["table"].bins, problem["table"].n_num,
                            num_steps=5))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk_slots,weighted,sub", [
    (16, False, True), (0, True, True), (4, True, True), (4, True, False)])
def test_batched_equals_per_class_builds_on_float_inputs(problem, chunk_slots,
                                                         weighted, sub):
    """The port's own contract: the class axis changes the schedule, never
    the arithmetic, on float targets and weights too."""
    cfg = TreeConfig(max_depth=5, task="regression_variance",
                     chunk_slots=chunk_slots, sibling_subtraction=sub,
                     hist_backend="kernel", select_backend="kernel")
    w = problem["h"] if weighted else None
    trees, arrays = build_trees_batched(problem["port"], problem["z"], cfg,
                                        sample_weight=w, device=CPU)
    for c in range(C):
        single = build_tree(problem["port"], problem["z"][c], cfg,
                            sample_weight=None if w is None else w[c],
                            device=CPU)
        _assert_trees_equal(trees[c], single)
        assert torch.equal(arrays["feat"][c], trees[c].feat)


def test_batched_torch_selection_with_min_child_weight(problem):
    cfg = TreeConfig(max_depth=5, task="regression_variance",
                     min_child_weight=3.0)
    trees, _ = build_trees_batched(problem["port"], problem["z"], cfg,
                                   sample_weight=problem["h"] * 20,
                                   device=CPU)
    for c in range(C):
        single = build_tree(problem["port"], problem["z"][c], cfg,
                            sample_weight=problem["h"][c] * 20, device=CPU)
        _assert_trees_equal(trees[c], single)


def test_batched_inert_rows_from_assign0(problem):
    """``assign0 = -1`` rows never enter a histogram: the batched build on
    the masked table equals the build on the kept rows alone."""
    keep = np.arange(problem["port"].bins.shape[0]) % 3 != 0
    assign0 = np.where(keep, 0, -1).astype(np.int32)
    cfg = TreeConfig(max_depth=4, task="regression_variance",
                     sibling_subtraction=False)
    trees, _ = build_trees_batched(problem["port"], problem["z_int"], cfg,
                                   sample_weight=problem["h_int"],
                                   assign0=assign0, device=CPU)
    sub = BinnedTable(bins=problem["port"].bins[keep],
                      n_num=problem["port"].n_num,
                      n_cat=problem["port"].n_cat, metas=[],
                      n_bins=problem["port"].n_bins)
    for c in range(C):
        single = build_tree(sub, problem["z_int"][c][keep], cfg,
                            sample_weight=problem["h_int"][c][keep],
                            device=CPU)
        n = single.n_nodes
        assert trees[c].n_nodes == n
        for f in EXACT:
            if f != "count":
                np.testing.assert_array_equal(
                    getattr(trees[c], f)[:n].numpy(),
                    getattr(single, f)[:n].numpy(), err_msg=f)


def test_walk_class_trees_equals_reference(problem):
    cfg = dict(max_depth=5, task="regression_variance")
    _, jarrays = jbatched(problem["table"], problem["z_int"], JConfig(**cfg),
                          sample_weight=problem["h_int"])
    np_arrays = {f: np.array(jarrays[f]) for f in WALK_FIELDS}
    for steps in (1, 3, 5):
        got = walk_class_trees(np_arrays, problem["port"].bins,
                               problem["port"].n_num, num_steps=steps,
                               device=CPU)
        want = jwalk({f: jarrays[f] for f in WALK_FIELDS},
                     problem["table"].bins, problem["table"].n_num,
                     num_steps=steps)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _chunks_per_level(trees, s_cap):
    """Level chunks of the lockstep build: per depth, the widest class's
    level cut into chunks of min(s_cap, max(16, next pow2))."""
    widths = np.stack([np.bincount(t.depth[:t.n_nodes].numpy(),
                                   minlength=64)[1:] for t in trees])
    total = 0
    for w in widths.max(axis=0):
        if w:
            s = min(s_cap, max(16, 1 << (int(w) - 1).bit_length()))
            total += -(-int(w) // s)
    return total


@pytest.mark.parametrize("chunk_slots", [16, 4])
def test_batched_build_one_histogram_call_per_level_chunk(problem,
                                                          monkeypatch,
                                                          chunk_slots):
    calls = {"histogram": 0, "histogram_stacked": 0, "split_scan": 0}
    for name in calls:
        orig = getattr(ops, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    cfg = TreeConfig(max_depth=5, task="regression_variance",
                     chunk_slots=chunk_slots, hist_backend="kernel",
                     select_backend="kernel")
    trees, _ = build_trees_batched(problem["port"], problem["z"], cfg,
                                   sample_weight=problem["h"], device=CPU)
    chunks = _chunks_per_level(trees, chunk_slots)
    assert chunks >= 5                # one chunk a level, or several
    assert calls == {"histogram": 0, "histogram_stacked": chunks,
                     "split_scan": chunks}


def test_batched_level_callback_gets_class_cursors(problem):
    seen = []
    cfg = TreeConfig(max_depth=4, task="regression_variance")
    trees, _ = build_trees_batched(problem["port"], problem["z"], cfg,
                                   sample_weight=problem["h"],
                                   level_callback=seen.append, device=CPU)
    assert [s.depth for s in seen] == [2, 3, 4, 5]
    for s in seen:
        assert s.level_start.shape == (C,) and s.next_free.shape == (C,)
        assert s.arrays["feat"].shape[0] == C and s.assign.shape[0] == C
    np.testing.assert_array_equal(seen[-1].next_free,
                                  [t.n_nodes for t in trees])


def test_batched_rejects_like_the_reference(problem):
    with pytest.raises(ValueError, match="regression_variance"):
        build_trees_batched(problem["port"], problem["z"], TreeConfig(),
                            device=CPU)
    with pytest.raises(ValueError, match="min_child_weight"):
        build_trees_batched(problem["port"], problem["z"],
                            TreeConfig(task="regression_variance",
                                       select_backend="kernel",
                                       min_child_weight=1.0), device=CPU)
    with pytest.raises(ValueError, match="regression_variance"):
        jbatched(problem["table"], problem["z"], JConfig())


def _stacked_case(mode, seed, lanes=3, m=400, k=5, b=9, c=3, s=8):
    g = torch.Generator().manual_seed(seed)
    bins = torch.randint(0, b, (m, k), generator=g, dtype=torch.int32)
    stats = torch.rand((lanes, m, c), generator=g)
    slot = torch.randint(-1, s, (lanes, m), generator=g, dtype=torch.int32)
    kw = dict(num_slots=s, n_bins=b)
    if mode in ("weights", "fused"):
        kw["weights"] = torch.rand((lanes, m), generator=g) + 0.5
    compute = None
    if mode in ("slot_map", "fused"):
        side = torch.randint(0, 2, (lanes, s // 2), generator=g)
        compute = torch.zeros((lanes, s), dtype=torch.bool)
        compute.scatter_(1, 2 * torch.arange(s // 2)[None] + side, True)
    return bins, stats, slot, compute, kw


@pytest.mark.parametrize("mode", ["plain", "weights", "slot_map", "fused"])
def test_stacked_histogram_equals_single_lane_calls(mode):
    """Every mode of the stacked plain version (the CPU path and the card's
    yardstick), lane by lane against one-lane calls."""
    bins, stats, slot, compute, kw = _stacked_case(mode, seed=len(mode))
    lanes, s = stats.shape[0], kw["num_slots"]
    w = kw.get("weights")
    if mode in ("plain", "weights"):
        got = ops.histogram_stacked(bins, stats, slot, **kw)
        for i in range(lanes):
            want = ops.histogram(bins, stats[i], slot[i], num_slots=s,
                                 n_bins=kw["n_bins"],
                                 weights=None if w is None else w[i])
            assert torch.equal(got[i], want)
        return
    slot_map = torch.where(compute, torch.arange(s) // 2, -1).to(torch.int32)
    phist = (torch.rand((lanes, s // 2, bins.shape[1], kw["n_bins"],
                         stats.shape[-1])) * 10 if mode == "fused" else None)
    side = compute[:, 0::2].to(torch.int32) if mode == "fused" else None
    got = ops.histogram_stacked(bins, stats, slot, num_slots=s // 2,
                                n_bins=kw["n_bins"], weights=w,
                                slot_map=slot_map, phist=phist, side=side)
    for i in range(lanes):
        want = ops.histogram(bins, stats[i], slot[i], num_slots=s // 2,
                             n_bins=kw["n_bins"],
                             weights=None if w is None else w[i],
                             slot_map=slot_map[i],
                             phist=None if phist is None else phist[i],
                             side=None if side is None else side[i])
        assert torch.equal(got[i], want)


@pytest.mark.parametrize("backend", ["segment", "onehot", "kernel"])
def test_stacked_node_histograms_equal_per_lane(backend):
    bins, stats, slot, compute, kw = _stacked_case("fused", seed=5)
    s, w = kw["num_slots"], kw["weights"]
    got = node_histogram_stacked(bins, stats, slot, num_slots=s,
                                 n_bins=kw["n_bins"], backend=backend,
                                 weights=w)
    phist = torch.rand((stats.shape[0], s // 2, bins.shape[1],
                        kw["n_bins"], stats.shape[-1]))
    fused = node_histogram_sibling_fused_stacked(
        bins, stats, slot, compute, phist, num_slots=s, n_bins=kw["n_bins"],
        backend=backend, weights=w)
    for i in range(stats.shape[0]):
        assert torch.equal(got[i], node_histogram(
            bins, stats[i], slot[i], num_slots=s, n_bins=kw["n_bins"],
            backend=backend, weights=w[i]))
        assert torch.equal(fused[i], node_histogram_sibling_fused(
            bins, stats[i], slot[i], compute[i], phist[i], num_slots=s,
            n_bins=kw["n_bins"], backend=backend, weights=w[i]))
