"""Port parity for forest serving (repro_torch.serve) on the CPU.

The first part is the port's counterpart of every test in
tests/test_serve_forest.py, run on the port's own CPU fits: lossless
packing, routed outputs bit-identical to each tenant's own
``predict_device`` / ``predict_proba_device``, bounded captures (one
serve executable per (bucket, model-set shape); on the CPU the executable
is the eager walk), padding that never leaks, the flush policy.

The second part holds the port against the reference on the same
carried-across tenants (``ensemble_from_numpy`` of a reference fit) and
the same numpy request rows: ``pack_trees`` arrays and dtypes and
``request_cost`` exactly equal; the routed walks' finiteness lanes and
every request's leaf node in every tree exactly equal; outputs within
rtol/atol 1e-6 (float32 sums of at most 6 terms added in another order).

On the CPU, torch's sigmoid rounds its vectorised body and its scalar
tail differently, so a logistic tenant's output is compared with its own
prediction on a batch of the same length, at the same position; on the
card the sigmoid is one elementwise function and tests/test_torch_cuda.py
compares across lengths.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import (GradientBoostedTrees as JGBT, TreeConfig as JConfig,
                        fit_bins as jfit_bins)
from repro.core.predict import paths as jpaths
from repro.data import make_classification as jmake_classification
from repro.resilience import poison_tenant as jpoison_tenant
from repro.serve import ModelRegistry as JRegistry
from repro.serve import pack_trees as jpack_trees
from repro_torch.core import (GradientBoostedTrees, TreeConfig,
                              ensemble_from_numpy, fit_bins, transform)
from repro_torch.core.predict import stack_trees
from repro_torch.data import (make_classification, make_regression,
                              train_val_test_split)
from repro_torch.resilience import poison_tenant
from repro_torch.serve import (BatchPolicy, ForestServer, ModelRegistry,
                               PackedForest, pack_stacked, pack_trees, unpack,
                               walk_bytes_per_request)
from repro_torch.serve.batching import serve_graph
from repro_torch.serve.pack import FAT_STEP_BYTES, predict_record_bytes
from repro_torch.serve.registry import _walk_nodes

CPU = "cpu"
PACK_FIELDS = ("feat", "op", "tbin", "loff", "label", "n_num")


def _fit(loss="squared", n_trees=5, max_depth=4, k=5, m=1200, seed=0,
         n_bins=16):
    if loss == "logistic":
        cols, y = make_classification(m, k, 2, seed=seed)
    else:
        cols, y = make_regression(m, k, seed=seed)
    (tr_c, tr_y), (va_c, _), _ = train_val_test_split(cols, y, seed=seed)
    table = fit_bins(tr_c, max_num_bins=n_bins)
    gbt = GradientBoostedTrees(
        n_trees=n_trees, loss=loss, seed=seed,
        config=TreeConfig(max_depth=max_depth, task="regression_variance"))
    gbt.fit(table, tr_y.astype(np.float32), device=CPU)
    return gbt, transform(va_c, table)


def _want(gbt, bins):
    """The tenant's own link-applied device walk, as numpy."""
    out = (gbt.predict_proba_device(bins) if gbt.loss == "logistic"
           else gbt.predict_device(bins))
    return out.numpy()


@pytest.fixture(scope="module")
def tenants():
    return [_fit("squared", n_trees=4, max_depth=4, seed=0),
            _fit("logistic", n_trees=6, max_depth=3, seed=1),
            _fit("squared", n_trees=2, max_depth=5, k=3, seed=2)]


# -- pack.py ---------------------------------------------------------------


def test_pack_round_trip_bit_exact():
    """unpack(pack(...)) reproduces every serve-relevant field exactly."""
    gbt, _ = _fit(n_trees=4, max_depth=5)
    packed = pack_trees(gbt)
    n = packed.max_nodes
    orig = {f: v.numpy()[:, :n] for f, v in stack_trees(gbt.trees).items()}
    got = unpack(packed)
    for f in ("feat", "op", "tbin", "left", "right", "label"):
        np.testing.assert_array_equal(got[f], orig[f].astype(got[f].dtype),
                                      err_msg=f)
    np.testing.assert_array_equal(got["leaf"], orig["leaf"].astype(bool))


def test_pack_trims_node_axis_and_narrows_dtypes():
    gbt, _ = _fit(n_trees=3, max_depth=3, k=4)
    packed = pack_trees(gbt)
    assert isinstance(packed.feat, np.ndarray)        # host-side numpy
    assert packed.max_nodes <= 15
    assert packed.max_nodes == max(t.n_nodes for t in gbt.trees)
    for f in ("feat", "op", "tbin", "loff"):
        assert getattr(packed, f).dtype == np.int8, f
    assert packed.record_bytes == 4
    assert packed.label.dtype == np.float32


_META = dict(learning_rate=1.0, base=0.0, link_id=0, num_steps=1,
             loss="squared")


def test_pack_overflow_rule_widens_per_field():
    """int8 overflows force int16 (and int16 -> int32), per field."""
    tables = dict(feat=np.array([[0, -1, -1]]),
                  op=np.array([[0, -1, -1]]),
                  tbin=np.array([[300, -1, -1]]),     # > int8
                  left=np.array([[1, -1, -1]]),
                  right=np.array([[2, -1, -1]]),
                  leaf=np.array([[False, True, True]]),
                  label=np.array([[0.0, 1.0, 2.0]], dtype=np.float32),
                  count=np.array([[3, 1, 2]]))
    p = pack_stacked(tables, n_num=[1], meta=_META)
    assert p.tbin.dtype == np.int16
    assert p.feat.dtype == np.int8
    assert p.record_bytes == 5
    assert walk_bytes_per_request(1, 1, p.record_bytes) == 5 + 4
    wide = dict(tables, tbin=np.array([[70_000, -1, -1]]))
    assert pack_stacked(wide, n_num=[1], meta=_META).tbin.dtype == np.int32


def test_predict_record_bytes_matches_pack():
    gbt, _ = _fit(n_trees=3, max_depth=3, k=4)
    packed = pack_trees(gbt)
    n_feat = max(int(t.feat.max()) + 1 for t in gbt.trees)
    n_bins = max(int(t.tbin.max()) + 1 for t in gbt.trees)
    max_loff = int(np.asarray(packed.loff).max(initial=0))
    assert predict_record_bytes(n_feat, n_bins, max_loff) == \
        packed.record_bytes
    assert predict_record_bytes(4, 301, 1) == 5


def test_pack_validates_sibling_pair_invariant():
    tables = dict(feat=np.array([[0, -1, -1]]), op=np.array([[0, -1, -1]]),
                  tbin=np.array([[1, -1, -1]]),
                  left=np.array([[1, -1, -1]]),
                  right=np.array([[5, -1, -1]]),      # not left + 1
                  leaf=np.array([[False, True, True]]),
                  label=np.zeros((1, 3), dtype=np.float32),
                  count=np.ones((1, 3)))
    with pytest.raises(ValueError, match="right == left"):
        pack_stacked(tables, n_num=[1], meta=_META)
    bad_leaf = dict(tables, right=np.array([[2, -1, -1]]),
                    leaf=np.array([[True, True, True]]))
    with pytest.raises(ValueError, match="leaf"):
        pack_stacked(bad_leaf, n_num=[1], meta=_META)


@pytest.mark.parametrize("seed", range(6))
def test_pack_round_trip_random_trees(seed):
    """Random valid sibling-pair trees (seeded numpy draws in place of the
    reference's hypothesis strategy) survive pack / unpack losslessly at
    every width the overflow rule picks."""
    rng = np.random.default_rng(seed)
    n_split = int(rng.integers(0, 41))
    n = 2 * n_split + 1
    left = np.full(n, -1, dtype=np.int64)
    left[:n_split] = 1 + 2 * np.arange(n_split)
    split = left >= 0
    k = int(rng.integers(1, 301))
    feat = np.where(split, rng.integers(0, k, n), -1)
    tbin = np.where(split, rng.integers(0, [128, 32_768, 70_001][seed % 3],
                                        n), -1)
    op = np.where(split, rng.integers(0, 3, n), -1)
    label = (np.round(rng.uniform(-1e6, 1e6, n), 3) * ~split).astype(
        np.float32)
    tables = dict(feat=feat[None], op=op[None], tbin=tbin[None],
                  left=left[None], right=np.where(split, left + 1, -1)[None],
                  leaf=~split[None], label=label[None], count=np.ones((1, n)))
    p = pack_stacked(tables, n_num=np.zeros(k), meta=_META)
    got = unpack(p)
    for f in ("feat", "op", "tbin", "left", "right", "label"):
        np.testing.assert_array_equal(got[f], tables[f].astype(got[f].dtype),
                                      err_msg=f)
    np.testing.assert_array_equal(got["leaf"], tables["leaf"])


# -- registry.py -----------------------------------------------------------


def test_routed_parity_single_and_mixed_tenants(tenants):
    """Routed predictions == each tenant's own link-applied device walk,
    bit for bit: single-tenant batches and a freely interleaved one."""
    registry = ModelRegistry(capacity=4, device=CPU)
    mids = [registry.add(f"t{i}", g) for i, (g, _) in enumerate(tenants)]
    wants = []
    for (gbt, bins), mid in zip(tenants, mids):
        want = _want(gbt, bins)
        got = registry.predict(np.full(bins.shape[0], mid),
                               registry.pad_bins(bins)).numpy()
        np.testing.assert_array_equal(want, got)
        wants.append(want)
    gids = np.array([mids[0], mids[1], mids[2], mids[2], mids[1], mids[0]])
    rows = np.concatenate([registry.pad_bins(tenants[m][1][j:j + 1])
                           for j, m in enumerate(gids)])
    got = registry.predict(gids, rows).numpy()
    # each row against its tenant's own walk over the same mixed rows
    # (a tenant reads only its own feature columns)
    want = np.array([_want(tenants[m][0], rows)[j]
                     for j, m in enumerate(gids)])
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        got[gids != mids[1]],
        np.array([wants[m][j] for j, m in enumerate(gids)
                  if m != mids[1]]))


def test_registry_eviction_reuses_slot_zero_recompiles(tenants):
    """remove() frees the slot without shrinking the envelope: shape_sig
    is unchanged, the cached executables keep serving (zero new entries
    across an evict -> re-add cycle), the freed id is rejected by
    submit, the lowest free slot is reused, survivors stay bit-exact."""
    (a, bins_a), (b, bins_b) = tenants[0], tenants[1]
    c, bins_c = _fit("squared", n_trees=2, max_depth=3, seed=2)
    registry = ModelRegistry(capacity=4, device=CPU)
    mid_a = registry.add("a", a)
    mid_b = registry.add("b", b)
    server = ForestServer(registry, BatchPolicy(buckets=(8,)))
    # the bucket's length: 5 rows padded to 8
    want_a = _want(a, bins_a[:8])[:5]
    want_b = _want(b, bins_b[:8])[:5]
    np.testing.assert_array_equal(want_a, server.predict(mid_a, bins_a[:5]))
    sig = registry.shape_sig
    compiles = server.compile_count
    tables = registry.tables

    with pytest.raises(KeyError, match="nobody"):
        registry.remove("nobody")
    assert registry.remove("a") == mid_a
    assert registry.shape_sig == sig
    with pytest.raises(ValueError, match="unknown model_id"):
        server.submit(mid_a, bins_a[:1])
    np.testing.assert_array_equal(want_b, server.predict(mid_b, bins_b[:5]))
    assert server.compile_count == compiles

    mid_c = registry.add("c", c)
    assert mid_c == mid_a
    assert registry.shape_sig == sig
    assert registry.tables is tables and all(
        registry.tables[f] is v for f, v in tables.items())  # in place
    np.testing.assert_array_equal(_want(c, bins_c[:8])[:5],
                                  server.predict(mid_c, bins_c[:5]))
    np.testing.assert_array_equal(want_b, server.predict(mid_b, bins_b[:5]))
    assert server.compile_count == compiles


def test_registry_byte_accounting():
    gbt, _ = _fit(n_trees=4)
    registry = ModelRegistry(capacity=2, device=CPU)
    registry.add("a", gbt)
    cost = registry.request_cost()
    t, s = registry._tree_cap, registry.num_steps
    assert cost["node_bytes_packed"] == walk_bytes_per_request(
        t, s, registry.record_bytes)
    assert cost["node_bytes_f32"] == walk_bytes_per_request(
        t, s, FAT_STEP_BYTES)
    assert cost["ratio"] <= 0.5
    assert cost["flops"] == s * t * 6 + t * 2 + 4


def test_registry_feature_count_mismatch_raises():
    gbt, _ = _fit(k=5)
    registry = ModelRegistry(capacity=2, device=CPU)
    registry.add("a", gbt)
    with pytest.raises(ValueError, match="feature"):
        registry.pad_bins(np.zeros((2, 9), dtype=np.int32))
    assert registry.pad_bins(np.zeros((2, 3), dtype=np.int32)).shape == (2, 5)


def test_softmax_tenant_refused():
    cols, y = make_classification(300, 4, 3, seed=5)
    table = fit_bins(cols, max_num_bins=16)
    ens = GradientBoostedTrees(
        n_trees=2, loss="softmax",
        config=TreeConfig(max_depth=3, task="regression_variance")).fit(
            table, y, device=CPU)
    registry = ModelRegistry(capacity=2, device=CPU)
    with pytest.raises(NotImplementedError, match="link_id=2"):
        registry.add("mc", ens)
    assert registry.tenants == []


def test_registry_and_chaos_raise_without_a_card(monkeypatch):
    from repro_torch.resilience import run_chaos
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRegistry(capacity=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_chaos(0)


# -- batching.py -----------------------------------------------------------


def test_bucket_selection_edges():
    gbt, _ = _fit(n_trees=2, max_depth=2)
    registry = ModelRegistry(capacity=2, device=CPU)
    registry.add("a", gbt)
    server = ForestServer(registry, BatchPolicy(buckets=(1, 8, 64)))
    assert server.bucket_for(1) == 1
    assert server.bucket_for(2) == 8
    assert server.bucket_for(8) == 8
    assert server.bucket_for(9) == 64
    assert server.bucket_for(64) == 64
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        server.bucket_for(65)
    with pytest.raises(ValueError, match="ascending"):
        BatchPolicy(buckets=(8, 1))


def test_padding_masked_bit_exact_and_oversize_chunking():
    """Padded rows never leak: every batch size around and past each
    bucket edge returns exactly predict_device's output."""
    gbt, bins = _fit(n_trees=3, max_depth=4, m=1500)
    registry = ModelRegistry(capacity=2, device=CPU)
    mid = registry.add("a", gbt)
    server = ForestServer(registry, BatchPolicy(buckets=(1, 8, 64)))
    want = _want(gbt, bins)
    for n in (1, 2, 7, 8, 9, 63, 64, 65, 150):
        got = server.predict(mid, bins[:n])
        np.testing.assert_array_equal(want[:n], got, err_msg=f"n={n}")
    assert server.stats["batches"] >= 3
    assert server.compile_count == 3


def test_compile_cache_one_per_bucket_and_in_envelope_add():
    """One executable per (bucket, model-set); replay hits the cache; an
    in-envelope tenant add keeps serving the same executables; envelope
    growth builds once per touched bucket and drops the old signature's
    entries (they held the reallocated tables)."""
    a, bins_a = _fit(n_trees=4, max_depth=4, seed=0)
    registry = ModelRegistry(capacity=4, device=CPU)
    mid_a = registry.add("a", a)
    server = ForestServer(registry, BatchPolicy(buckets=(8, 64)))

    server.predict(mid_a, bins_a[:5])
    server.predict(mid_a, bins_a[:60])
    assert server.compile_count == 2
    server.predict(mid_a, bins_a[:5])
    server.predict(mid_a, bins_a[:60])
    assert server.compile_count == 2
    sig = registry.shape_sig

    b, bins_b = _fit(n_trees=2, max_depth=3, seed=1)
    mid_b = registry.add("b", b)
    assert registry.shape_sig == sig
    np.testing.assert_array_equal(_want(b, bins_b),
                                  server.predict(mid_b, bins_b))
    np.testing.assert_array_equal(_want(a, bins_a)[:5],
                                  server.predict(mid_a, bins_a[:5]))
    assert server.compile_count == 2

    c, bins_c = _fit(n_trees=8, max_depth=5, seed=2)
    mid_c = registry.add("c", c)
    assert registry.shape_sig != sig
    server.predict(mid_c, bins_c[:5])
    assert server.compile_count == 3
    assert set(server._exec) == {(8, registry.shape_sig)}
    assert server._exec[(8, registry.shape_sig)].tables is registry.tables
    server.predict(mid_c, bins_c[:5])
    assert server.compile_count == 3
    np.testing.assert_array_equal(_want(a, bins_a)[:5],
                                  server.predict(mid_a, bins_a[:5]))
    np.testing.assert_array_equal(_want(c, bins_c[:8])[:5],
                                  server.predict(mid_c, bins_c[:5]))


def test_serve_graph_on_the_cpu_is_the_eager_walk(tenants):
    """A CPU registry's cache entry holds no graph: its run is the eager
    walk over static bucket buffers, equal to ``predict_checked``."""
    registry = ModelRegistry(capacity=4, device=CPU)
    mids = [registry.add(f"t{i}", g) for i, (g, _) in enumerate(tenants)]
    entry = serve_graph(registry, 8)
    assert entry.graph is None and entry.bins.shape == (8, 5)
    gids = np.array([mids[j % 3] for j in range(8)], np.int32)
    rows = np.concatenate([registry.pad_bins(tenants[j % 3][1][j:j + 1])
                           for j in range(8)])
    out, ok = entry.run(gids, rows)
    want, want_ok = registry.predict_checked(gids, rows)
    np.testing.assert_array_equal(out, want.numpy())
    np.testing.assert_array_equal(ok, want_ok.numpy())


def test_flush_policy_injected_timestamps():
    """max_delay flushes via tick(); max_batch flushes inside submit();
    result() forces a flush; outputs split back per request exactly."""
    gbt, bins = _fit(n_trees=2, max_depth=3)
    registry = ModelRegistry(capacity=2, device=CPU)
    mid = registry.add("a", gbt)
    want = _want(gbt, bins)

    server = ForestServer(registry, BatchPolicy(
        buckets=(8, 64), max_delay=0.5, max_batch=16))
    p1 = server.submit(mid, bins[:3], now=100.0)
    p2 = server.submit(mid, bins[3:5], now=100.1)
    assert not p1.done() and not p2.done()
    server.tick(now=100.2)
    assert not p1.done()
    server.tick(now=100.6)
    assert p1.done() and p2.done()
    np.testing.assert_array_equal(want[:3], p1.result())
    np.testing.assert_array_equal(want[3:5], p2.result())
    assert server.stats["batches"] == 1

    p3 = server.submit(mid, bins[:10], now=200.0)
    assert not p3.done()
    p4 = server.submit(mid, bins[10:16], now=200.0)
    assert p3.done() and p4.done()
    np.testing.assert_array_equal(want[:10], p3.result())

    p5 = server.submit(mid, bins[:2], now=300.0)
    np.testing.assert_array_equal(want[:2], p5.result())


def test_unknown_model_id_rejected():
    gbt, bins = _fit(n_trees=2, max_depth=2)
    registry = ModelRegistry(capacity=2, device=CPU)
    registry.add("a", gbt)
    server = ForestServer(registry)
    with pytest.raises(ValueError, match="unknown model_id"):
        server.submit(5, bins[:1])
    with pytest.raises(ValueError, match="unknown model_id"):
        server.submit(-1, bins[:1])


# -- against the reference -------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """Three reference fits (squared and logistic, different depths and
    feature counts) and their port counterparts, carried across with
    ``ensemble_from_numpy``; plus numpy request rows."""
    out = []
    for i, (loss, n_trees, depth, k) in enumerate(
            [("squared", 4, 4, 5), ("logistic", 6, 3, 5),
             ("squared", 3, 5, 3)]):
        cols, y = jmake_classification(900, k, 2, seed=20 + i,
                                       n_cat_features=1)
        y = np.asarray(y, np.float32)
        if loss == "squared":
            y = y + np.random.default_rng(i).normal(size=len(y)).astype(
                np.float32)
        table = jfit_bins(cols, max_num_bins=32)
        cfg = dict(max_depth=depth, task="regression_variance")
        ref = JGBT(n_trees=n_trees, learning_rate=0.3, config=JConfig(**cfg),
                   loss=loss, seed=i).fit(table, y)
        ens = ensemble_from_numpy(
            [t._asdict() for t in ref.trees], base=ref.base,
            learning_rate=0.3, loss=loss, n_num=ref.n_num,
            config=TreeConfig(**cfg), device=CPU)
        out.append((ref, ens, np.asarray(table.bins)))
    return out


def test_pack_trees_of_carried_ensemble_equals_reference(carried):
    for ref, ens, _ in carried:
        want, got = jpack_trees(ref), pack_trees(ens)
        for f in PACK_FIELDS:
            a, b = getattr(want, f), getattr(got, f)
            assert b.dtype == a.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        assert got.meta == want.meta


def test_reference_packed_forest_registers_unchanged(carried):
    """A PackedForest built from a reference PackedForest's numpy fields
    registers in the port's registry and serves the same bits as the
    port's own packing of the carried-across ensemble."""
    reg_a = ModelRegistry(capacity=4, device=CPU)
    reg_b = ModelRegistry(capacity=4, device=CPU)
    for i, (ref, ens, _) in enumerate(carried):
        jp = jpack_trees(ref)
        reg_a.add(f"t{i}", PackedForest(
            **{f.name: getattr(jp, f.name)
               for f in dataclasses.fields(PackedForest)}))
        reg_b.add(f"t{i}", ens)
    assert reg_a.shape_sig == reg_b.shape_sig
    for i, (_, ens, bins) in enumerate(carried):
        rows = reg_a.pad_bins(bins[:64])
        gids = np.full(64, i)
        got = reg_a.predict(gids, rows).numpy()
        np.testing.assert_array_equal(got, reg_b.predict(gids, rows).numpy())
        want = (ens.predict_proba_device(bins[:64]) if ens.loss == "logistic"
                else ens.predict_device(bins[:64])).numpy()
        np.testing.assert_array_equal(got, want)


def test_request_cost_equals_reference(carried):
    jreg = JRegistry(capacity=4)
    reg = ModelRegistry(capacity=4, device=CPU)
    for i, (ref, ens, _) in enumerate(carried):
        jreg.add(f"t{i}", ref)
        reg.add(f"t{i}", ens)
        assert reg.shape_sig == jreg.shape_sig
        assert reg.request_cost() == jreg.request_cost()


def test_routed_walk_matches_reference(carried):
    """Both packages' routed walks on the same carried-across tenants (one
    poisoned in both) and the same mixed request rows: ok lanes and every
    request's leaf node in every tree exactly equal, outputs within
    1e-6."""
    jreg = JRegistry(capacity=4)
    reg = ModelRegistry(capacity=4, device=CPU)
    for i, (ref, ens, _) in enumerate(carried):
        jreg.add(f"t{i}", ref)
        reg.add(f"t{i}", ens)
    rng = np.random.default_rng(0)
    gids = rng.integers(0, len(carried), 300).astype(np.int32)
    rows = np.stack([reg.pad_bins(carried[g][2][j:j + 1])[0]
                     for j, g in enumerate(gids)])

    def both():
        jo, jok = jreg.predict_checked(gids, rows)
        to, tok = reg.predict_checked(gids, rows)
        return np.asarray(jo), np.asarray(jok), to.numpy(), tok.numpy()

    jo, jok, to, tok = both()
    assert jok.all()
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)

    nodes = _walk_nodes(reg.tables, torch.from_numpy(rows),
                        torch.from_numpy(gids), reg.num_steps)[0].numpy()
    for g, (ref, _, _) in enumerate(carried):
        sel = np.flatnonzero(gids == g)
        k = len(ref.n_num)
        for t, tree in enumerate(ref.trees):
            want = np.asarray(jpaths(tree, rows[sel, :k], ref.n_num))[:, -1]
            np.testing.assert_array_equal(nodes[t, sel], want,
                                          err_msg=f"tenant {g} tree {t}")
        assert (nodes[len(ref.trees):, sel] == 0).all()  # padded lanes

    jpoison_tenant(jreg, 1)
    poison_tenant(reg, 1)
    jo, jok, to, tok = both()
    assert not jok.all() and jok.any()
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_allclose(to[tok], jo[jok], rtol=1e-6, atol=1e-6)
