"""The port's spans and counters (``repro_torch.tracing``) on the CPU, at
small shapes: nothing without a profiler; under one, every span name on the
paths of a build, a sweep and a boosted fit, nested as the level loop
nests, with host syncs and host-device bytes equal to the arithmetic of
the inputs; results bit for bit the same either way."""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.core import (BinnedTable, GossConfig,  # noqa: E402
                              GradientBoostedTrees, TreeConfig, build_tree,
                              fit_bins, sweep)
from repro_torch.core import tree as tree_mod  # noqa: E402
from repro_torch.core.forest import _validate_fit_inputs  # noqa: E402
from repro_torch.core.tree import TREE_FIELDS  # noqa: E402
from repro_torch.data import make_classification  # noqa: E402

M, K, C = 2400, 6, 3
PREFIXES = ("tree.", "gbt.", "toot.")
# the tree arrays the sweep's cost model reads whole: depth, count, left,
# right, parent, feat, tbin, left again (int32) and leaf (bool)
SWEEP_SLOT_BYTES = 8 * 4 + 1


@pytest.fixture(scope="module")
def data():
    cols, y = make_classification(3000, K, C, seed=0)
    table = fit_bins(cols, max_num_bins=32)
    train = BinnedTable(bins=table.bins[:M], n_num=table.n_num,
                        n_cat=table.n_cat, metas=table.metas,
                        n_bins=table.n_bins)
    return train, y[:M], table.bins[M:], y[M:], table.n_num


@pytest.fixture(autouse=True)
def fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


def _build(d, chunk_slots=0):
    train, y = d[0], d[1]
    return build_tree(train, y, TreeConfig(chunk_slots=chunk_slots),
                      n_classes=C, device="cpu")


def _sweep(d, tree):
    return sweep(tree, d[2], d[3], d[4], train_size=M, device="cpu")


def _fit(d, rounds=3):
    """A GOSS fit on the table as the fit takes it on the card: the bins a
    tensor on the fit's device."""
    train, y = d[0], d[1]
    table = BinnedTable(bins=torch.as_tensor(train.bins), n_num=train.n_num,
                        n_cat=train.n_cat, metas=None, n_bins=train.n_bins)
    model = GradientBoostedTrees(
        n_trees=rounds, learning_rate=0.1,
        config=TreeConfig(max_depth=4, task="regression_variance"),
        goss=GossConfig(0.2, 0.1), loss="logistic", seed=5)
    return model.fit(table, (y > 0).astype(np.float32), device="cpu")


def _traced(fn):
    """``fn()`` under the profiler: its result and the program's spans as
    ``(name, start, end)``, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith(PREFIXES)),
                   key=lambda s: s[1])
    return out, spans


def _chunks(tree, chunk_slots):
    """Level chunks of a build from its tree: one a level, or with
    ``chunk_slots`` at most 16 (even) that many slots a chunk."""
    depth = tree.depth[:tree.n_nodes].numpy()
    widths = np.bincount(depth)[1:]
    if not chunk_slots:
        return len(widths)
    return int(sum(-(-w // chunk_slots) for w in widths))


def _slots(tree, chunk_slots):
    """The slots of a build's level chunks from its tree: a level of width
    w in chunks of S = min(cap, max(16, w rounded up to a power of 2))."""
    widths = np.bincount(tree.depth[:tree.n_nodes].numpy())[1:]
    s = [min(chunk_slots or 4096, max(16, 1 << (int(w) - 1).bit_length()))
         for w in widths]
    return int(sum(si * -(-int(w) // si) for si, w in zip(s, widths)))


def _same_tree(a, b):
    assert a.n_nodes == b.n_nodes
    for f in TREE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_off_without_a_profiler(data, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tree = _build(data)
    _sweep(data, tree)
    _fit(data)
    assert set(tracing.counters()) == set(tracing.COUNTERS)
    assert not any(tracing.counters().values())
    assert tracing.span("tree.build") is tracing.span("toot.sweep")


def test_every_span_emitted_and_no_other(data):
    def run():
        _sweep(data, _build(data))
        _fit(data)

    _, spans = _traced(run)
    names = {n for n, _, _ in spans}
    assert names == set(tracing.SPANS)
    sites = set().union(*(c.keys() for c in tracing.counters().values()))
    assert sites <= set(tracing.SPANS)


def test_level_spans_nest_and_count_the_levels(data):
    tree, spans = _traced(lambda: _build(data, chunk_slots=4))

    def of(name):
        return [(a, b) for n, a, b in spans if n == name]

    def inside(inner, outer):
        return all(any(oa <= a and b <= ob for oa, ob in of(outer))
                   for a, b in of(inner))

    assert len(of("tree.build")) == len(of("tree.upload")) == 1
    assert inside("tree.level", "tree.build")
    assert inside("tree.upload", "tree.build")
    for name in ("tree.chunk", "tree.children", "tree.route"):
        assert inside(name, "tree.level")
    assert len(of("tree.level")) == len(of("tree.route")) == tree.max_tree_depth
    assert len(of("tree.chunk")) == len(of("tree.children")) \
        == _chunks(tree, 4) > tree.max_tree_depth


@pytest.mark.parametrize("chunk_slots", [0, 4])
def test_build_counts_its_uploads_and_a_sync_a_chunk(data, chunk_slots):
    tree, _ = _traced(lambda: _build(data, chunk_slots))
    c = tracing.counters()
    # bins, int32 labels (the one-hot statistics are made from them on the
    # device), n_num, n_cat
    assert c["h2d_bytes"] == {"tree.upload": M * K * 4 + M * 4 + 2 * K * 4}
    assert c["host_syncs"] == {"tree.children": _chunks(tree, chunk_slots)}
    # n_children, an int64 a chunk
    assert c["d2h_bytes"] == {"tree.children": 8 * _chunks(tree, chunk_slots)}
    # S slots a chunk, of which the tree's nodes held one each
    assert c["stack_slots"] == {"tree.chunk": _slots(tree, chunk_slots)}
    assert c["stack_slots_used"] == {"tree.chunk": tree.n_nodes}


def test_sweep_counts_its_reads(data):
    tree = _build(data)
    res, _ = _traced(lambda: _sweep(data, tree))
    c = tracing.counters()
    max_nodes = 2 * M + 1
    grid = res.metric.size
    n_val = len(data[3])
    # the tree's depth, the grid's totals and nine whole tree arrays
    assert c["host_syncs"] == {"toot.sweep": 1, "toot.paths": 1,
                               "toot.cost": 9}
    assert c["d2h_bytes"] == {"toot.sweep": 4, "toot.paths": 4 * grid,
                              "toot.cost": SWEEP_SLOT_BYTES * max_nodes}
    # validation bins and n_num, labels, then the three grid axes
    axes = sum(a.nbytes for a in (res.smin, res.mcw, res.dmax))
    assert c["h2d_bytes"] == {"toot.paths": n_val * K * 4 + K * 4
                              + n_val * 4 + axes}


def test_fit_counts_its_trees_syncs_and_its_own_two(data):
    """A fit on integer bins already in the fit's memory: a sync a level
    chunk, and the fit's own two transfers, the labels and ``n_num`` up in
    ``gbt.validate`` and the base score's read (its one sync) in
    ``gbt.fit``.  The validation reads nothing back, and a round's build
    uploads ``n_num`` and ``n_cat`` alone."""
    model, spans = _traced(lambda: _fit(data, rounds=3))
    syncs = tracing.counters()["host_syncs"]
    assert sum(syncs.values()) == sum(_chunks(t, 0) for t in model.trees) + 1
    assert syncs["gbt.fit"] == 1 and "gbt.validate" not in syncs
    for name in ("gbt.round", "gbt.gradients", "gbt.goss", "gbt.update",
                 "tree.build"):
        assert sum(1 for n, _, _ in spans if n == name) == 3
    c = tracing.counters()
    assert "gbt.validate" not in c["d2h_bytes"]
    assert c["h2d_bytes"] == {"gbt.validate": M * 4 + K * 4,  # labels, n_num
                              "tree.upload": 3 * (2 * K * 4)}  # n_num, n_cat


def _validated(table, y):
    """``_validate_fit_inputs`` inside ``gbt.validate`` under the
    profiler."""
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("gbt.validate"):
            _validate_fit_inputs(table, y)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.int16,
                                   torch.uint8])
def test_validate_reads_nothing_back_for_integer_tensor_bins(data, dtype):
    train, y = data[0], data[1]
    _validated(dataclasses.replace(
        train, bins=torch.as_tensor(train.bins).to(dtype)),
        y.astype(np.float32))
    assert not any(tracing.counters().values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.float16])
def test_validate_reads_one_flag_for_finite_float_tensor_bins(data, dtype):
    train, y = data[0], data[1]
    _validated(dataclasses.replace(
        train, bins=torch.as_tensor(train.bins).to(dtype)),
        y.astype(np.float32))
    assert tracing.counters() == {"host_syncs": {"gbt.validate": 1},
                                  "h2d_bytes": {},
                                  "d2h_bytes": {"gbt.validate": 1},
                                  "stack_slots": {}, "stack_slots_used": {},
                                  "levels_uncached": {}}


@pytest.mark.parametrize("task", ["classification", "regression_variance",
                                  "regression"])
def test_device_made_operands_build_the_host_made_tree(data, task,
                                                       monkeypatch):
    """A build on tensors, whose row operands are made on the device or
    left out where the task reads none, gives the tree of the same build
    fed host numpy inputs and every operand as a host array: one-hot rows
    of ``np.eye``, zero statistics, label bins and targets."""
    train, y = data[0], data[1]
    classes = task == "classification"
    yt = y if classes else (y + 0.25 * train.bins[:, 0]).astype(np.float32)
    n_classes = C if classes else None
    cfg = TreeConfig(max_depth=6, task=task)
    real = tree_mod._chunk_step
    seen = set()

    def device_made(bins, stats, lbins, yv, *args, **kw):
        seen.add((stats is None, lbins is None, yv is None))
        return real(bins, stats, lbins, yv, *args, **kw)

    monkeypatch.setattr(tree_mod, "_chunk_step", device_made)
    on_device = build_tree(
        dataclasses.replace(train, bins=torch.as_tensor(train.bins)),
        yt if classes else torch.as_tensor(yt), cfg, n_classes=n_classes,
        device="cpu")
    # what each task leaves out: classification reads the statistics
    # alone, the regressions the targets (and the label split its bins)
    assert seen == {{"classification": (False, True, True),
                     "regression_variance": (True, True, False),
                     "regression": (True, False, False)}[task]}
    m = len(yt)

    def host_made(bins, stats, lbins, yv, *args, **kw):
        if classes:
            stats = torch.as_tensor(np.eye(C, dtype=np.float32)[yt])
            yv = torch.as_tensor(np.zeros(m, np.float32))
        else:
            stats = torch.as_tensor(np.zeros((m, 3 if lbins is None else 2),
                                             np.float32))
        if lbins is None:
            lbins = torch.as_tensor(np.zeros(m, np.int32))
        return real(bins, stats, lbins, yv, *args, **kw)

    monkeypatch.setattr(tree_mod, "_chunk_step", host_made)
    _same_tree(on_device, build_tree(train, yt, cfg, n_classes=n_classes,
                                     device="cpu"))


def test_results_bit_equal_with_tracing_on_and_off(data):
    tree_off = _build(data, 4)
    res_off = _sweep(data, tree_off)
    fit_off = _fit(data)
    (tree_on, res_on, fit_on), _ = _traced(
        lambda: (_build(data, 4), _sweep(data, tree_off), _fit(data)))
    _same_tree(tree_on, tree_off)
    assert np.array_equal(res_on.metric, res_off.metric)
    assert np.array_equal(res_on.n_nodes, res_off.n_nodes)
    assert res_on.best == res_off.best
    assert fit_on.base == fit_off.base
    for a, b in zip(fit_on.trees, fit_off.trees, strict=True):
        _same_tree(a, b)


def test_helpers_do_what_the_calls_they_replace_do():
    x = np.arange(12, dtype=np.int64).reshape(3, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        t = tracing.to_device(x, torch.int32, "cpu")
        same = tracing.to_device(t, torch.int32, "cpu")
        back = tracing.to_host(t)
        v = tracing.read_scalar(t.max())
    assert t.dtype == torch.int32 and torch.equal(t, torch.as_tensor(x))
    assert same is t
    assert back.dtype == np.int32 and np.array_equal(back, x)
    assert v == 11 and isinstance(v, int)
    # a tensor already in the program's memory is not an upload
    assert tracing.counters() == {"host_syncs": {"outside": 2},
                                  "h2d_bytes": {"outside": 48},
                                  "d2h_bytes": {"outside": 52},
                                  "stack_slots": {}, "stack_slots_used": {},
                                  "levels_uncached": {}}


def test_unknown_span_refused_while_on():
    assert tracing.span("tree.nope") is tracing.span("tree.build")
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="SPANS"):
            tracing.span("tree.nope")
        with tracing.span("tree.build"):
            tracing.read_scalar(torch.zeros((), dtype=torch.float32))
    assert tracing.counters()["host_syncs"] == {"tree.build": 1}


# -- the multiclass path: a softmax round's C class-trees in one build ------

def _fit_softmax(d, rounds=3, chunk_slots=0):
    """A softmax fit (C classes, no GOSS) on tensor bins, the table as the
    fit takes it on the card."""
    train, y = d[0], d[1]
    table = BinnedTable(bins=torch.as_tensor(train.bins), n_num=train.n_num,
                        n_cat=train.n_cat, metas=None, n_bins=train.n_bins)
    model = GradientBoostedTrees(
        n_trees=rounds, learning_rate=0.1,
        config=TreeConfig(max_depth=4, task="regression_variance",
                          min_samples_leaf=5, min_child_weight=1e-3,
                          chunk_slots=chunk_slots),
        loss="softmax", seed=5)
    return model.fit(table, y, device="cpu")


def _lockstep(model, chunk_slots):
    """What the batched level loop does a fit, from its class-trees: the
    levels, the chunks (and of them those past the root, which gather
    parent rows), the stacked slots and those that held a node."""
    n_cls = model._loss.n_classes
    s_cap = chunk_slots or 4096
    out = dict(levels=0, chunks=0, sub_chunks=0, slots=0, used=0)
    for r in range(0, len(model.trees), n_cls):
        widths = np.stack([np.bincount(t.depth[:t.n_nodes].numpy(),
                                       minlength=64)[1:]
                           for t in model.trees[r:r + n_cls]])
        for d, w in enumerate(widths.T):
            wmax = int(w.max())
            if not wmax:
                break
            s = min(s_cap, max(16, 1 << (wmax - 1).bit_length()))
            chunks = -(-wmax // s)
            out["levels"] += 1
            out["chunks"] += chunks
            out["sub_chunks"] += chunks if d else 0
            out["slots"] += n_cls * s * chunks
            out["used"] += int(w.sum())
    return out


def test_softmax_round_spans_nest(data):
    model, spans = _traced(lambda: _fit_softmax(data, rounds=3))

    def of(name):
        return [(a, b) for n, a, b in spans if n == name]

    def inside(inner, outer):
        return all(any(oa <= a and b <= ob for oa, ob in of(outer))
                   for a, b in of(inner))

    for name in ("gbt.round", "gbt.gradients", "gbt.update", "tree.build",
                 "tree.upload"):
        assert len(of(name)) == 3, name
    assert not of("gbt.goss")
    for name in ("gbt.gradients", "gbt.update", "tree.build"):
        assert inside(name, "gbt.round")
    assert inside("gbt.round", "gbt.fit")
    assert inside("tree.upload", "tree.build")
    for name in ("tree.chunk", "tree.children", "tree.route"):
        assert inside(name, "tree.level")
    assert inside("tree.level", "tree.build")
    steps = _lockstep(model, 0)
    assert len(of("tree.level")) == len(of("tree.route")) == steps["levels"]
    assert len(of("tree.chunk")) == len(of("tree.children")) == steps["chunks"]


@pytest.mark.parametrize("chunk_slots", [0, 2])
def test_softmax_fit_counts_a_sync_a_chunk_and_its_stacked_slots(
        data, chunk_slots):
    """A sync and an ``[C]`` int64 read a chunk, under ``tree.children``;
    ``C * S`` stacked slots a chunk and, of them, every class-tree node
    once; the uploads of the fit (labels, ``n_num``), of each build
    (``n_num``, ``n_cat``) and of the level loop's cursors."""
    model, _ = _traced(lambda: _fit_softmax(data, 3, chunk_slots))
    c = tracing.counters()
    steps = _lockstep(model, chunk_slots)
    if chunk_slots:
        assert steps["chunks"] > steps["levels"]
    assert c["host_syncs"] == {"tree.children": steps["chunks"], "gbt.fit": 1}
    assert c["d2h_bytes"] == {"tree.children": 8 * C * steps["chunks"],
                              "gbt.fit": 4 * C}
    assert c["stack_slots"] == {"tree.chunk": steps["slots"]}
    assert c["stack_slots_used"] == {
        "tree.chunk": sum(t.n_nodes for t in model.trees)}
    # int32 cs, cn, next_free a chunk, int64 chunk starts and level bases
    # past the root, int32 level bounds a route
    assert c["h2d_bytes"] == {
        "gbt.validate": M * 8 + K * 4,
        "tree.upload": 3 * 2 * K * 4,
        "tree.chunk": 12 * C * steps["chunks"] + 16 * C * steps["sub_chunks"],
        "tree.route": 8 * C * steps["levels"]}


def test_softmax_off_enters_no_record_function(data, monkeypatch):
    on, _ = _traced(lambda: _fit_softmax(data, rounds=2, chunk_slots=2))
    tracing.reset()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = _fit_softmax(data, rounds=2, chunk_slots=2)
    assert not any(tracing.counters().values())
    assert np.array_equal(on.base, off.base)
    for a, b in zip(on.trees, off.trees, strict=True):
        _same_tree(a, b)
