"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``gpu``) and skips without
one; the decision is taken inside the ``cuda`` fixture, never at import.
Run on the card with ``pytest -m gpu tests/test_torch_cuda.py``.  This file
imports torch, numpy and repro_torch only, and one test the benchmark's
profiler reader (``portbench.trace``) inside it.

Tolerances: integer-count stats exact (f32 integers below 2**24 are exact
in any order); float stats rtol 1e-5 against the plain version, and bit
for bit from launch to launch; split-scan scores rtol/atol 1e-5, bin and
op equal wherever the best candidate is unique."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.core import TreeConfig, build_tree, fit_bins
from repro_torch.data import make_classification
from repro_torch.kernels import ops, ref
from repro_torch.kernels.histogram import (histogram_cuda, histogram_plain,
                                           histogram_stacked_cuda,
                                           histogram_stacked_plain)
from repro_torch.kernels.split_scan import split_scan_cuda, split_scan_plain

pytestmark = pytest.mark.gpu

SHAPES = [
    # (M, K, B, C, S): the small shapes of tests/test_kernels.py, then the
    # main path's (KDD99-10%: 494,021 rows, 41 features, 257 bins, 5
    # classes) at a narrow level (16 slots) and at the widest chunk (1272)
    (64, 1, 4, 2, 1),
    (300, 5, 17, 4, 6),
    (1000, 2, 8, 26, 3),
    (37, 7, 5, 3, 2),
    (494021, 41, 257, 5, 16),
    (494021, 41, 257, 5, 1272),
]
MODES = ["plain", "weights", "slot_map", "fused", "pairs"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(m, k, b, c, s, mode, integer, dev, seed=0):
    """Inputs made on the card from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_raw = 2 * s if mode in ("slot_map", "fused", "pairs") else s

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    bins = ints(0, b, (m, k))
    if integer:
        stats = torch.eye(c, device=dev)[ints(0, c, (m,)).long()]
    else:
        stats = torch.rand((m, c), generator=g, device=dev)
    slot = ints(-1, n_raw + 1, (m,))
    kw = {}
    if mode == "weights":
        kw["weights"] = (ints(1, 4, (m,)).float() if integer
                         else torch.rand((m,), generator=g, device=dev) + 0.5)
    if mode in ("slot_map", "fused"):
        side = ints(0, 2, (s,)).long()
        compute = torch.zeros(n_raw, dtype=torch.bool, device=dev)
        compute[2 * torch.arange(s, device=dev) + side] = True
        kw["slot_map"] = torch.where(
            compute, torch.arange(n_raw, device=dev) // 2, -1).to(torch.int32)
    if mode in ("fused", "pairs"):
        kw["phist"] = ints(0, 9, (s, k, b, c)).float()
    if mode == "fused":
        kw["side"] = (1 - side).to(torch.int32)
    return bins, stats, slot, kw


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,b,c,s", SHAPES)
def test_histogram_kernel_matches_plain_exact_counts(cuda, m, k, b, c, s, mode):
    bins, stats, slot, kw = _case(m, k, b, c, s, mode, True, cuda)
    got = histogram_cuda(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    want = histogram_plain(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,b,c,s", SHAPES[1:2] + SHAPES[4:5])
def test_histogram_kernel_matches_plain_float_stats(cuda, m, k, b, c, s, mode):
    bins, stats, slot, kw = _case(m, k, b, c, s, mode, False, cuda, seed=1)
    got = histogram_cuda(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    want = histogram_plain(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _scan_case(s, k, b, c, dev, seed, moment=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    if moment:
        cnt = torch.poisson(torch.full((s, k, b), 5.0, device=dev), generator=g)
        mu = torch.randn((s, k, b), generator=g, device=dev)
        hist = torch.stack([cnt, cnt * mu, cnt * (mu * mu + 0.1)], dim=-1)
    else:
        hist = torch.poisson(torch.full((s, k, b, c), 2.0, device=dev),
                             generator=g)
    n_num = torch.randint(0, b, (k,), generator=g, device=dev,
                          dtype=torch.int32)
    n_cat = torch.minimum(torch.randint(0, 4, (k,), generator=g, device=dev,
                                        dtype=torch.int32), b - n_num)
    return hist, n_num, n_cat


@pytest.mark.parametrize("heur", ["info_gain", "gini", "chi_square", "sse"])
@pytest.mark.parametrize("m,k,b,c,s", SHAPES)
def test_split_scan_kernel_matches_plain(cuda, m, k, b, c, s, heur):
    hist, n_num, n_cat = _scan_case(s, k, b, c, cuda, seed=s,
                                    moment=heur == "sse")
    kw = dict(heuristic=heur, min_leaf=2)
    s1, b1, o1 = split_scan_cuda(hist, n_num, n_cat, **kw)
    s0, b0, o0 = split_scan_plain(hist, n_num, n_cat, **kw)
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-5)
    unique = ref.best_is_unique(hist, n_num, n_cat, **kw)
    assert torch.equal(b1[unique], b0[unique])
    assert torch.equal(o1[unique], o0[unique])


def test_launch_counts_and_wrapper_checks(cuda):
    bins, stats, slot, kw = _case(300, 5, 17, 4, 6, "fused", True, cuda)
    ops.reset_launch_counts()
    ops.histogram(bins, stats, slot, num_slots=6, n_bins=17, **kw)
    ops.split_scan(torch.ones((2, 5, 17, 4), device=cuda),
                   torch.full((5,), 10, dtype=torch.int32, device=cuda),
                   torch.zeros(5, dtype=torch.int32, device=cuda))
    assert ops.launch_counts() == {"histogram": 0, "histogram_weights": 0,
                                   "histogram_slot_map": 1,
                                   "histogram_fused": 1,
                                   "histogram_stacked": 0,
                                   "histogram_pairs": 0, "split_scan": 1,
                                   "linear_scan": 0,
                                   "linear_scan_backward": 0, "walk": 0}
    st = _stacked_case(3, 300, 5, 17, 4, 6, "fused", True, cuda)
    ops.histogram_stacked(*st[:3], num_slots=6, n_bins=17, **st[3])
    assert ops.launch_counts()["histogram_stacked"] == 1
    assert ops.launch_counts()["histogram_fused"] == 2
    with pytest.raises(TypeError):
        histogram_cuda(bins.long(), stats, slot, num_slots=6, n_bins=17)
    with pytest.raises(ValueError):
        histogram_cuda(bins.t().contiguous().t(), stats, slot, num_slots=6,
                       n_bins=17)


@pytest.mark.parametrize("sub", [True, False])
def test_kernel_build_equals_plain_build(cuda, sub):
    cols, y = make_classification(3000, 6, 3, seed=3, n_cat_features=2,
                                  missing_frac=0.05)
    table = fit_bins(cols, max_num_bins=32)
    cfg = TreeConfig(max_depth=12, chunk_slots=16, hist_backend="kernel",
                     select_backend="kernel", sibling_subtraction=sub)
    on_card = build_tree(table, y, cfg, n_classes=3, device=cuda)
    on_cpu = build_tree(table, y, cfg, n_classes=3, device="cpu")
    assert on_card.n_nodes == on_cpu.n_nodes
    for f in ("feat", "op", "tbin", "label", "count", "depth", "left",
              "right", "leaf", "parent"):
        assert torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)), f
    torch.testing.assert_close(on_card.score.cpu(), on_cpu.score,
                               rtol=1e-5, atol=1e-5)


def test_tracing_on_the_card_counts_what_the_cpu_counts(cuda):
    """The small build's syncs and bytes by span are the CPU's, and no
    span is taken for device work by the benchmark's profiler reader."""
    import pathlib
    import sys
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from portbench import trace
    cols, y = make_classification(3000, 6, 3, seed=3, n_cat_features=2,
                                  missing_frac=0.05)
    table = fit_bins(cols, max_num_bins=32)
    cfg = TreeConfig(max_depth=12, chunk_slots=16, hist_backend="kernel",
                     select_backend="kernel")
    counts = {}
    for dev in ("cpu", cuda):
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            build_tree(table, y, cfg, n_classes=3, device=dev)
        counts[str(dev)] = tracing.counters()
    assert counts["cuda"] == counts["cpu"]
    assert counts["cuda"]["host_syncs"]["tree.children"] >= 2
    prof = trace.profile(lambda: build_tree(table, y, cfg, n_classes=3,
                                            device=cuda), 1)
    tracing.reset()
    spans = set(tracing.SPANS)
    assert {"tree.build", "tree.level", "tree.children"} <= {
        n for n, _, _ in prof.host}
    assert prof.device and not {n for n, _, _ in prof.device} & spans
    assert not {n for n, _ in prof.breakdown()["device_ops"]} & spans


def _lockstep_counts(model, chunk_slots):
    """The syncs, ``[C]`` reads and stacked slots of a softmax fit's
    batched level loop, worked out on the host from its class-trees: a
    chunk's ``C * S`` slots, and every node in one of them."""
    n_cls = model._loss.n_classes
    chunks = slots = 0
    for r in range(0, len(model.trees), n_cls):
        widths = np.stack([np.bincount(t.depth[:t.n_nodes].cpu().numpy(),
                                       minlength=64)[1:]
                           for t in model.trees[r:r + n_cls]]).max(0)
        for wmax in widths[widths > 0]:
            s = min(chunk_slots, max(16, 1 << (int(wmax) - 1).bit_length()))
            chunks += -(-int(wmax) // s)
            slots += n_cls * s * -(-int(wmax) // s)
    return {"host_syncs": {"tree.children": chunks, "gbt.fit": 1},
            "d2h_bytes": {"tree.children": 8 * n_cls * chunks,
                          "gbt.fit": 4 * n_cls},
            "stack_slots": {"tree.chunk": slots},
            "stack_slots_used": {"tree.chunk": sum(t.n_nodes
                                                   for t in model.trees)}}


def test_softmax_fit_on_the_card_counts_what_the_cpu_counts(cuda):
    """A softmax fit's syncs, reads and class-stacked slots are kept on
    the host from the level loop's cursors, so on the card, as on the CPU,
    they are the arithmetic of the fit's class-trees; the uploads that do
    not depend on the trees' shapes are the CPU's byte for byte.  (The
    card's fixed-point sums may break a near-tie another way than the
    CPU's float32 ones, so the two fits' trees need not be the same.)"""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.core import BinnedTable, GradientBoostedTrees
    cols, y = make_classification(3000, 6, 3, seed=3, n_cat_features=2,
                                  missing_frac=0.05)
    table = fit_bins(cols, max_num_bins=32)
    cfg = TreeConfig(max_depth=5, task="regression_variance",
                     min_samples_leaf=5, min_child_weight=1e-3,
                     chunk_slots=2, hist_backend="kernel")
    counts = {}
    for dev in ("cpu", cuda):
        tbl = BinnedTable(bins=torch.as_tensor(table.bins, device=dev),
                          n_num=table.n_num, n_cat=table.n_cat, metas=None,
                          n_bins=table.n_bins)
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            model = GradientBoostedTrees(
                n_trees=2, learning_rate=0.1, config=cfg, loss="softmax",
                seed=1).fit(tbl, y, device=dev)
        counts[str(dev)] = c = tracing.counters()
        for name, want in _lockstep_counts(model, 2).items():
            assert c[name] == want, (dev, name)
        assert c["host_syncs"]["tree.children"] > 2 * 5
    tracing.reset()
    for site in ("gbt.validate", "tree.upload"):
        assert counts["cuda"]["h2d_bytes"][site] == counts["cpu"]["h2d_bytes"][site]


def _poison_allocator(shape, dev):
    """Leave a NaN-filled block of ``shape`` in the caching allocator, so an
    output allocated next with torch.empty starts as NaN where the kernel
    does not write."""
    junk = torch.full(shape, float("nan"), device=dev)
    del junk


@pytest.mark.parametrize("mode", ["plain", "weights", "fused"])
def test_histogram_one_full_slot_many_empty(cuda, mode):
    """Every row in one slot (split over several row chunks and merged),
    most slots empty: every output cell is written without a memset."""
    m, k, b, c, s = 3 * 4096 + 77, 41, 257, 5, 8
    g = torch.Generator(device=cuda).manual_seed(5)
    bins = torch.randint(0, b, (m, k), generator=g, device=cuda,
                         dtype=torch.int32)
    stats = torch.eye(c, device=cuda)[torch.randint(0, c, (m,), generator=g,
                                                    device=cuda)]
    kw = {}
    if mode == "fused":
        slot = torch.full((m,), 5, dtype=torch.int32, device=cuda)
        # raw slot 5 is the computed child of pair 2; the rest drop
        kw["slot_map"] = torch.tensor([-1, -1, -1, -1, -1, 2, -1, -1, -1, -1,
                                       -1, -1, -1, -1, -1, -1],
                                      dtype=torch.int32, device=cuda)
        kw["phist"] = torch.randint(0, 9, (s, k, b, c), generator=g,
                                    device=cuda).float()
        kw["side"] = torch.tensor([1, 0, 0, 1, 0, 1, 0, 1], dtype=torch.int32,
                                  device=cuda)
        out_shape = (2 * s, k, b, c)
    else:
        slot = torch.full((m,), 3, dtype=torch.int32, device=cuda)
        if mode == "weights":
            kw["weights"] = torch.randint(1, 4, (m,), generator=g,
                                          device=cuda).float()
        out_shape = (s, k, b, c)
    want = histogram_plain(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    torch.cuda.synchronize()
    _poison_allocator(out_shape, cuda)
    got = histogram_cuda(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    torch.cuda.synchronize()
    assert not got.isnan().any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["plain", "fused"])
@pytest.mark.parametrize("m,k,b,c,s", [
    (6000, 3, 300, 70, 4),      # one feature's [B, C] wider than a tile
    (20000, 2, 5, 2, 5000),     # more slots than one sort window holds
])
def test_histogram_bin_tiles_and_slot_windows(cuda, m, k, b, c, s, mode):
    bins, stats, slot, kw = _case(m, k, b, c, s, mode, True, cuda, seed=7)
    got = histogram_cuda(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    want = histogram_plain(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    assert torch.equal(got, want)


def test_histogram_fused_alternating_side(cuda):
    """Fused mode with side = 1, 0, 1, 0, ...; some pairs hold more rows
    than one chunk, some none."""
    m, k, b, c, p = 40000, 9, 33, 3, 6
    g = torch.Generator(device=cuda).manual_seed(6)
    bins = torch.randint(0, b, (m, k), generator=g, device=cuda,
                         dtype=torch.int32)
    stats = torch.eye(c, device=cuda)[torch.randint(0, c, (m,), generator=g,
                                                    device=cuda)]
    # raw slots 0..2p-1, skewed so that pair 0's child gets most rows
    slot = torch.where(torch.rand((m,), generator=g, device=cuda) < 0.6, 0,
                       torch.randint(-1, 2 * p, (m,), generator=g,
                                     device=cuda)).to(torch.int32)
    side = torch.arange(p, device=cuda, dtype=torch.int32) % 2 == 0
    compute = torch.stack([side, ~side], dim=1).reshape(2 * p)
    slot_map = torch.where(compute, torch.arange(2 * p, device=cuda) // 2,
                           -1).to(torch.int32)
    slot_map[10] = -1                       # pair 5 gets no rows at all
    phist = torch.randint(0, 50, (p, k, b, c), generator=g,
                          device=cuda).float()
    kw = dict(num_slots=p, n_bins=b, slot_map=slot_map, phist=phist,
              side=side.to(torch.int32))
    got = histogram_cuda(bins, stats, slot, **kw)
    want = histogram_plain(bins, stats, slot, **kw)
    assert torch.equal(got, want)
    assert torch.equal(got, ref.sibling_ref(bins, stats, slot, slot_map, phist,
                                            side.to(torch.int32), num_pairs=p,
                                            n_bins=b))


def _float_case(s, mode, kind, dev, seed):
    """Main-path-shaped inputs with float values: class rows under float
    weights in every mode ("float_weights"), or (1, y, y^2) moment rows
    with float weights in the weights mode only ("moments")."""
    m, k, b = 494021, 41, 257
    c = 5 if kind == "float_weights" else 3
    bins, stats, slot, kw = _case(m, k, b, c, s, mode, True, dev, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    w = torch.rand((m,), generator=g, device=dev) + 0.5
    if kind == "float_weights":
        kw["weights"] = w
    else:
        y = 3.0 * torch.randn((m,), generator=g, device=dev)
        stats = torch.stack([torch.ones_like(y), y, y * y], dim=1)
        if mode == "weights":
            kw["weights"] = w
    return bins, stats, slot, kw


def _double(kw):
    return {k: v.double() if k in ("weights", "phist") else v
            for k, v in kw.items()}


@pytest.mark.parametrize("kind", ["float_weights", "moments"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("s", [16, 1272])
def test_histogram_float_weights_run_to_run(cuda, s, mode, kind):
    """Two launches with float values give the same H bit for bit (the
    float path accumulates in fixed point, so the sum does not depend on
    the order rows or atomics arrive in), each within rtol/atol 1e-5 of
    the plain version summed in float64 (the float32 plain version itself
    is off by up to 2.6e-5 on these moment sums)."""
    bins, stats, slot, kw = _float_case(s, mode, kind, cuda, seed=2)
    a = histogram_cuda(bins, stats, slot, num_slots=s, n_bins=257, **kw)
    b = histogram_cuda(bins, stats, slot, num_slots=s, n_bins=257, **kw)
    want = histogram_plain(bins, stats.double(), slot, num_slots=s,
                           n_bins=257, **_double(kw))
    torch.testing.assert_close(a.double(), want, rtol=1e-5, atol=1e-5)
    differ = int((a != b).sum())
    assert differ == 0, (f"{differ} of {a.numel()} cells differ between two "
                         f"launches (max abs "
                         f"{float((a - b).abs().max()):.3g})")


@pytest.mark.parametrize("mode", ["weights", "fused"])
def test_histogram_float_order_independent(cuda, mode):
    """The same rows in another order give the same H bit for bit."""
    bins, stats, slot, kw = _float_case(16, mode, "float_weights", cuda,
                                        seed=4)
    perm = torch.randperm(bins.shape[0], device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(9))
    a = histogram_cuda(bins, stats, slot, num_slots=16, n_bins=257, **kw)
    kw_p = dict(kw, weights=kw["weights"][perm])
    b = histogram_cuda(bins[perm].contiguous(), stats[perm].contiguous(),
                       slot[perm].contiguous(), num_slots=16, n_bins=257,
                       **kw_p)
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["weights", "fused"])
@pytest.mark.parametrize("m,k,b,c,s", [
    (6000, 3, 300, 70, 4),      # bin tiles: one feature cut into bin halves
    (20000, 2, 5, 2, 5000),     # more slots than one sort window holds
    (3 * 4096 + 77, 41, 257, 5, 8),   # few slots of several chunks each
])
def test_histogram_float_path_edge_shapes(cuda, m, k, b, c, s, mode):
    """The fixed-point path on the tilings and plans the integer tests
    cover: within rtol/atol 1e-5 of the float64 plain sum, every cell
    written (allocator pre-poisoned with NaN), two launches bit-equal."""
    bins, stats, slot, kw = _case(m, k, b, c, s, mode, False, cuda, seed=8)
    kw["weights"] = torch.rand((m,), device=cuda,
                               generator=torch.Generator(device=cuda)
                               .manual_seed(3)) + 0.5
    want = histogram_plain(bins, stats.double(), slot, num_slots=s,
                           n_bins=b, **_double(kw))
    torch.cuda.synchronize()
    _poison_allocator(tuple(want.shape), cuda)
    got = histogram_cuda(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    again = histogram_cuda(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    assert not got.isnan().any()
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)


def _tie_hist(dev):
    """[2, 3, 8, 2] class counts whose best candidates tie exactly:
    feature 0 is a numeric palindrome ("<=" at b ties with ">" at b and
    with "<=" at 6 - b), feature 1 has equal categorical bins, feature 2
    has no candidate that passes min_leaf."""
    pal = [[5, 0], [0, 5], [3, 3], [1, 1], [1, 1], [3, 3], [0, 5], [5, 0]]
    cat = [[2, 0], [2, 0], [4, 4], [4, 4], [4, 4], [4, 4], [0, 0], [0, 0]]
    one = [[0, 0]] * 7 + [[1, 0]]
    h = torch.tensor([pal, cat, one], dtype=torch.float32, device=dev)
    h = torch.stack([h, h.flip(1)])          # slot 1: bins reversed
    n_num = torch.tensor([8, 2, 0], dtype=torch.int32, device=dev)
    n_cat = torch.tensor([0, 4, 8], dtype=torch.int32, device=dev)
    return h, n_num, n_cat


@pytest.mark.parametrize("heur", ["info_gain", "gini", "chi_square"])
def test_split_scan_exact_ties_first_maximum(cuda, heur):
    """Exact score ties across ops and bins: the kernel keeps the flat
    op-major first maximum, as the plain version does."""
    hist, n_num, n_cat = _tie_hist(cuda)
    s1, b1, o1 = split_scan_cuda(hist, n_num, n_cat, heuristic=heur,
                                 min_leaf=1)
    s0, b0, o0 = split_scan_plain(hist, n_num, n_cat, heuristic=heur,
                                  min_leaf=1)
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-5)
    assert torch.equal(b1, b0) and torch.equal(o1, o0)
    # a "<=" / ">" tie at one bin goes to "<=" (op 0); no candidate of
    # feature 2 passes min_leaf, so it returns NEG_INF at flat index 0
    assert int(o1[0, 0]) == 0
    neg_inf = torch.tensor(-3.4e38, dtype=torch.float32, device=cuda)
    assert torch.equal(s1[:, 2], neg_inf.expand(2)) and int(b1[0, 2]) == 0


@pytest.mark.parametrize("c", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("heur", ["info_gain", "gini", "chi_square", "sse"])
def test_split_scan_257_bins_partial_features(cuda, c, heur):
    """B = 257 (not a multiple of 32) with n_num + n_cat < B on every
    feature, for each compiled channel count and the generic one."""
    s, k, b = 24, 13, 257
    hist, _, _ = _scan_case(s, k, b, c, cuda, seed=c, moment=heur == "sse")
    g = torch.Generator(device=cuda).manual_seed(11)
    n_num = torch.randint(0, 200, (k,), generator=g, device=cuda,
                          dtype=torch.int32)
    n_cat = torch.randint(0, 40, (k,), generator=g, device=cuda,
                          dtype=torch.int32)
    assert bool(((n_num + n_cat) < b).all())
    kw = dict(heuristic=heur, min_leaf=3)
    s1, b1, o1 = split_scan_cuda(hist, n_num, n_cat, **kw)
    s0, b0, o0 = split_scan_plain(hist, n_num, n_cat, **kw)
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-5)
    unique = ref.best_is_unique(hist, n_num, n_cat, **kw)
    assert torch.equal(b1[unique], b0[unique])
    assert torch.equal(o1[unique], o0[unique])


def test_split_scan_block_wider_than_shared_memory(cuda):
    """A [B, C] block too wide for shared memory takes the global scratch
    path of the same kernel."""
    hist = torch.poisson(torch.full((2, 3, 2000, 30), 1.0, device=cuda))
    n_num = torch.tensor([1500, 10, 0], dtype=torch.int32, device=cuda)
    n_cat = torch.tensor([400, 1900, 2000], dtype=torch.int32, device=cuda)
    s1, b1, o1 = split_scan_cuda(hist, n_num, n_cat, min_leaf=1)
    s0, b0, o0 = split_scan_plain(hist, n_num, n_cat, min_leaf=1)
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-5)
    unique = ref.best_is_unique(hist, n_num, n_cat, min_leaf=1)
    assert torch.equal(b1[unique], b0[unique])
    assert torch.equal(o1[unique], o0[unique])


def test_boosted_fits_on_the_card_are_bit_identical(cuda):
    """Every boosted round adds float weights (hessians x GOSS
    amplification) in the weights and fused histogram modes; two fits give
    the same trees in every field, and the first rounds of a longer fit
    are the shorter fit."""
    from repro_torch.core import GossConfig, GradientBoostedTrees
    from repro_torch.core.tree import TREE_FIELDS
    cols, y = make_classification(20000, 8, 2, seed=4, n_cat_features=2,
                                  missing_frac=0.02)
    table = fit_bins(cols, max_num_bins=64)

    def fit(r):
        return GradientBoostedTrees(
            n_trees=r, learning_rate=0.3, loss="logistic", seed=1,
            goss=GossConfig(0.2, 0.2),
            config=TreeConfig(max_depth=6, task="regression_variance",
                              hist_backend="kernel",
                              select_backend="kernel"),
        ).fit(table, y.astype("float32"), device=cuda)

    ops.reset_launch_counts()
    a = fit(6)
    counts = ops.launch_counts()
    assert counts["histogram_weights"] > 0 and counts["histogram_fused"] > 0
    for other in (fit(6), fit(3)):
        for ta, tb in zip(a.trees, other.trees):
            assert ta.n_nodes == tb.n_nodes
            for f in TREE_FIELDS:
                assert torch.equal(getattr(ta, f), getattr(tb, f)), f


def test_goss_fit_on_card_bins_copies_only_what_the_host_holds(cuda):
    """A GOSS fit on bins already on the card: a round's build uploads
    ``n_num`` and ``n_cat`` alone, the validation reads nothing back, and
    the trees equal those of a fit fed the same bins from the host."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.core import GossConfig, GradientBoostedTrees
    from repro_torch.core.tree import TREE_FIELDS
    cols, y = make_classification(20000, 8, 2, seed=4, n_cat_features=2,
                                  missing_frac=0.02)
    table = fit_bins(cols, max_num_bins=64)
    k, rounds = table.bins.shape[1], 4

    def fit(t):
        return GradientBoostedTrees(
            n_trees=rounds, learning_rate=0.3, loss="logistic", seed=1,
            goss=GossConfig(0.2, 0.2),
            config=TreeConfig(max_depth=6, task="regression_variance",
                              hist_backend="kernel",
                              select_backend="kernel"),
        ).fit(t, y.astype("float32"), device=cuda)

    on_card = dataclasses.replace(table, bins=torch.as_tensor(
        table.bins, dtype=torch.int32, device=cuda))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        a = fit(on_card)
    c = tracing.counters()
    tracing.reset()
    assert c["h2d_bytes"]["tree.upload"] == rounds * 2 * k * 4
    assert "gbt.validate" not in c["d2h_bytes"]
    assert "gbt.validate" not in c["host_syncs"]
    b = fit(table)
    assert len(a.trees) == len(b.trees) == rounds
    for ta, tb in zip(a.trees, b.trees):
        assert ta.n_nodes == tb.n_nodes
        for f in TREE_FIELDS:
            assert torch.equal(getattr(ta, f), getattr(tb, f)), f


def test_card_sweep_equals_cpu_sweep(cuda):
    """A tree grown on the card, priced on the card and on the CPU: equal
    metric, node and byte grids, fronts and best cells."""
    from repro_torch.core import SweepSpace, sweep
    cols, y = make_classification(6000, 8, 3, seed=7, n_cat_features=2)
    table = fit_bins(cols, max_num_bins=64)
    tree = build_tree(table, y,
                      TreeConfig(max_depth=64, hist_backend="kernel"),
                      n_classes=3, device=cuda)
    space = SweepSpace(mcw_values=(0.0, 3.0, 20.0))
    kw = dict(space=space, train_size=len(y))
    got = sweep(tree, table.bins, y, table.n_num, device=cuda, **kw)
    want = sweep(tree, table.bins, y, table.n_num, device="cpu", **kw)
    for f in ("metric", "n_nodes", "walk_bytes"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.front == want.front and got.best == want.best


# ----------------------------------------------------- class-stacked mode

def _stacked_case(lanes, m, k, b, c, s, mode, integer, dev, seed=0,
                  scales=None):
    """``lanes`` lanes over one shared bins table: lane l's stats / slots /
    weights (and slot_map, phist, side) drawn as ``_case`` draws them, its
    float values times ``scales[l]`` (so that every lane has its own
    fixed-point scale)."""
    lane_cases = [_case(m, k, b, c, s, mode, integer, dev, seed=seed + l)
                  for l in range(lanes)]
    bins = lane_cases[0][0]
    stats = torch.stack([lc[1] for lc in lane_cases])
    if scales is not None:
        stats = stats * torch.tensor(scales, device=dev)[:, None, None]
    slot = torch.stack([lc[2] for lc in lane_cases])
    kw = {key: torch.stack([lc[3][key] for lc in lane_cases])
          for key in lane_cases[0][3]}
    return bins, stats.contiguous(), slot, kw


def _lane_kw(kw, l):
    return {key: v[l] for key, v in kw.items()}


@pytest.mark.parametrize("lanes", [1, 3, 5])
@pytest.mark.parametrize("mode", MODES)
def test_stacked_histogram_matches_plain(cuda, mode, lanes):
    """Integer counts exact; float stats (each lane on its own scale)
    within rtol/atol 1e-5 of the float64 plain sum."""
    m, k, b, c, s = 30000, 41, 257, 5, 16
    bins, stats, slot, kw = _stacked_case(lanes, m, k, b, c, s, mode, True,
                                          cuda)
    got = histogram_stacked_cuda(bins, stats, slot, num_slots=s, n_bins=b,
                                 **kw)
    want = histogram_stacked_plain(bins, stats, slot, num_slots=s, n_bins=b,
                                   **kw)
    torch.cuda.synchronize()
    paired = mode in ("fused", "pairs")
    assert got.shape == want.shape == (lanes, (2 if paired else 1) * s, k,
                                       b, c)
    assert torch.equal(got, want)
    scales = [10.0 ** (2 * l - 2) for l in range(lanes)]
    bins, stats, slot, kw = _stacked_case(lanes, m, k, b, c, s, mode, False,
                                          cuda, seed=11, scales=scales)
    got = histogram_stacked_cuda(bins, stats, slot, num_slots=s, n_bins=b,
                                 **kw)
    want = histogram_stacked_plain(bins, stats.double(), slot, num_slots=s,
                                   n_bins=b, **_double(kw))
    for l in range(lanes):
        torch.testing.assert_close(got[l].double(), want[l],
                                   rtol=1e-5, atol=1e-5 * scales[l])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,s", [(494021, 16), (3 * 4096 + 77, 1272),
                                 (200, 5)])
def test_stacked_lanes_equal_single_launches(cuda, mode, m, s):
    """Lane l of one stacked launch equals, bit for bit, a one-lane launch
    on lane l's inputs: lanes 0 and 2 hold integer counts (the int32
    path), lanes 1, 3 and 4 float stats on scales 1e-3 .. 1e3 (the fixed-
    point path, each lane on its own scale), in one launch."""
    k, b, c = 41, 257, 5
    bins, st_int, slot, kw = _stacked_case(5, m, k, b, c, s, mode, True,
                                           cuda, seed=3)
    _, st_f, _, _ = _stacked_case(5, m, k, b, c, s, mode, False, cuda,
                                  seed=3, scales=[1, 1e-3, 1, 1e3, 7.0])
    stats = torch.where(torch.tensor([1, 0, 1, 0, 0], dtype=torch.bool,
                                     device=cuda)[:, None, None],
                        st_int, st_f).contiguous()
    got = histogram_stacked_cuda(bins, stats, slot, num_slots=s, n_bins=b,
                                 **kw)
    again = histogram_stacked_cuda(bins, stats, slot, num_slots=s, n_bins=b,
                                   **kw)
    for l in range(5):
        one = histogram_cuda(bins, stats[l].contiguous(), slot[l].contiguous(),
                             num_slots=s, n_bins=b, **_lane_kw(kw, l))
        assert torch.equal(got[l], one), f"lane {l}"
    assert torch.equal(got, again)


@pytest.mark.parametrize("mode", ["weights", "fused"])
def test_stacked_run_to_run_bit_equal_on_a_boosting_round(cuda, mode):
    """A softmax round's shapes: 5 lanes of (1, z, z^2) moment rows under
    float hessian weights over 177,845 rows, two launches bit-equal, each
    within rtol/atol 1e-5 of the float64 plain sum."""
    m, k, b, s = 177845, 41, 257, 16
    bins, _, slot, kw = _stacked_case(5, m, k, b, 3, s, mode, True, cuda,
                                      seed=5)
    g = torch.Generator(device=cuda).manual_seed(6)
    z = 2.0 * torch.randn((5, m), generator=g, device=cuda)
    stats = torch.stack([torch.ones_like(z), z, z * z], dim=-1).contiguous()
    kw["weights"] = torch.rand((5, m), generator=g, device=cuda) * 0.25
    a = histogram_stacked_cuda(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    c = histogram_stacked_cuda(bins, stats, slot, num_slots=s, n_bins=b, **kw)
    want = histogram_stacked_plain(bins, stats.double(), slot, num_slots=s,
                                   n_bins=b, **_double(kw))
    torch.testing.assert_close(a.double(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(a, c)


@pytest.mark.parametrize("sub", [True, False])
def test_batched_build_on_the_card_equals_per_class_card_builds(cuda, sub):
    from repro_torch.core import build_trees_batched
    from repro_torch.core.tree import TREE_FIELDS
    cols, y = make_classification(20000, 8, 4, seed=4, n_cat_features=2,
                                  missing_frac=0.02)
    table = fit_bins(cols, max_num_bins=64)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(4, len(y))).astype(np.float32)
    h = rng.uniform(0.05, 0.25, (4, len(y))).astype(np.float32)
    cfg = TreeConfig(max_depth=8, task="regression_variance", chunk_slots=16,
                     hist_backend="kernel", select_backend="kernel",
                     sibling_subtraction=sub)
    ops.reset_launch_counts()
    trees, _ = build_trees_batched(table, z, cfg, sample_weight=h,
                                   device=cuda)
    counts = ops.launch_counts()
    assert counts["histogram_stacked"] == counts["split_scan"] > 8
    for c in range(4):
        one = build_tree(table, z[c], cfg, sample_weight=h[c], device=cuda)
        assert trees[c].n_nodes == one.n_nodes
        for f in TREE_FIELDS:
            assert torch.equal(getattr(trees[c], f), getattr(one, f)), (c, f)


@pytest.mark.parametrize("heur", ["info_gain", "sse"])
def test_split_scan_never_picks_masked_features(cuda, heur):
    """RandomForest's feature mask: n_num = n_cat = 0 leaves a feature no
    candidate, even where its histogram holds the best split."""
    hist, n_num, n_cat = _scan_case(64, 41, 257, 3 if heur == "sse" else 5,
                                    cuda, seed=4, moment=heur == "sse")
    mask = torch.arange(41, device=cuda) % 3 == 0
    n_num_m = torch.where(mask, 0, n_num).to(torch.int32)
    n_cat_m = torch.where(mask, 0, n_cat).to(torch.int32)
    score, tbin, op = split_scan_cuda(hist, n_num_m, n_cat_m, heuristic=heur,
                                      min_leaf=1)
    s0, _, _ = split_scan_plain(hist, n_num_m, n_cat_m, heuristic=heur,
                                min_leaf=1)
    torch.testing.assert_close(score, s0, rtol=1e-5, atol=1e-5)
    assert bool((score[:, mask] <= -1e30).all())
    assert bool((score[:, ~mask] > -1e30).any())
    from repro_torch.core.split import best_splits_kernel
    dec = best_splits_kernel(hist, n_num_m, n_cat_m, heuristic=heur)
    assert not bool(mask[dec.feat.long()].any())


@pytest.mark.parametrize("mode", ["weights", "fused"])
def test_stacked_many_lanes_in_one_sort_block(cuda, mode):
    """23 lanes (KDD99's 23 labels) of 1,000 rows: every sort block holds
    rows of several lanes, each lane on its own scale; each lane equals a
    one-lane launch and the float64 plain sum."""
    lanes, m, k, b, c, s = 23, 1000, 41, 257, 3, 16
    scales = [10.0 ** ((l % 7) - 3) for l in range(lanes)]
    bins, stats, slot, kw = _stacked_case(lanes, m, k, b, c, s, mode, False,
                                          cuda, seed=21, scales=scales)
    got = histogram_stacked_cuda(bins, stats, slot, num_slots=s, n_bins=b,
                                 **kw)
    want = histogram_stacked_plain(bins, stats.double(), slot, num_slots=s,
                                   n_bins=b, **_double(kw))
    for l in range(lanes):
        one = histogram_cuda(bins, stats[l].contiguous(), slot[l].contiguous(),
                             num_slots=s, n_bins=b, **_lane_kw(kw, l))
        assert torch.equal(got[l], one), f"lane {l}"
        torch.testing.assert_close(got[l].double(), want[l], rtol=1e-5,
                                   atol=1e-5 * scales[l])


def _pairs_lanes(lanes, values, dev, m=60000, k=41, b=257, c=5, p=16):
    """``lanes`` lanes of raw child slots [0, 2p) for a ``pairs`` launch:
    pair 0 tied, pair 1 empty, rows at -1 and past 2p, the last lane empty
    when there are several; pair 2's right child (not chosen: it holds
    more rows) holds the lane's largest |value| (fixed point: its scale
    must come from the chosen children alone) or its one non-integer
    value (int32: so must the integer flag).  ``values``: ``int``,
    ``int_weights``, ``fixed`` or ``fixed_weights``."""
    g = torch.Generator(device=dev).manual_seed(lanes * 100 + len(values))
    bins = torch.randint(0, b, (m, k), generator=g, device=dev,
                         dtype=torch.int32)
    if values.startswith("int"):
        stats = torch.eye(c, device=dev)[torch.randint(
            0, c, (lanes, m), generator=g, device=dev)]
    else:
        stats = torch.randn((lanes, m, c), generator=g, device=dev)
    slot = torch.randint(6, 2 * p + 2, (lanes, m), generator=g, device=dev,
                         dtype=torch.int32)
    slot[:, :200] = torch.arange(200, device=dev, dtype=torch.int32) % 2
    slot[:, 200:260], slot[:, 260:3000] = 4, 5
    slot[:, 3000:3100] = -1
    stats[:, 260] = 0.5 if values.startswith("int") else 1e6
    if lanes > 1:
        slot[-1] = -1
    kw = dict(num_slots=p, n_bins=b, phist=torch.randint(
        0, 9, (lanes, p, k, b, c), generator=g, device=dev).float())
    if values == "int_weights":
        kw["weights"] = torch.randint(1, 4, (lanes, m), generator=g,
                                      device=dev).float()
    elif values == "fixed_weights":
        kw["weights"] = torch.rand((lanes, m), generator=g, device=dev) + 0.5
    return bins, stats.contiguous(), slot, kw


@pytest.mark.parametrize("lanes", [1, 5])
@pytest.mark.parametrize("values", ["int", "int_weights", "fixed",
                                    "fixed_weights"])
def test_pairs_launch_bit_equal_to_the_fused_launch_given_the_mask(
        cuda, lanes, values):
    """A ``pairs`` launch (the smaller children picked in the kernel) gives
    the H of the fused launch given ``smaller_child_mask``'s mask, bit for
    bit: the same children, int32-or-fixed choice and scale; and it is
    within the plain version (float64 for fixed point) of that mask."""
    from repro_torch.core.histogram import smaller_child_mask
    bins, stats, slot, kw = _pairs_lanes(lanes, values, cuda)
    p = kw["num_slots"]
    compute = smaller_child_mask(slot, 2 * p)
    assert bool(compute[:, 0].all()) and bool(compute[:, 4].all())
    explicit = dict(kw, side=compute[:, 0::2].to(torch.int32),
                    slot_map=torch.where(compute, torch.arange(
                        2 * p, device=cuda) // 2, -1).to(torch.int32))
    if lanes == 1:
        one = {key: v[0] if isinstance(v, torch.Tensor) else v
               for key, v in kw.items()}
        got = histogram_cuda(bins, stats[0], slot[0], **one)
        want = histogram_cuda(bins, stats[0], slot[0], **{
            key: v[0] if isinstance(v, torch.Tensor) else v
            for key, v in explicit.items()})[None]
        got = got[None]
    else:
        got = histogram_stacked_cuda(bins, stats, slot, **kw)
        want = histogram_stacked_cuda(bins, stats, slot, **explicit)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = histogram_stacked_plain(bins, stats.double(), slot,
                                    **_double(kw))
    torch.testing.assert_close(got.double(), plain, rtol=1e-5, atol=1e-5)
    if lanes > 1:
        assert torch.equal(got[-1, 1::2], kw["phist"][-1])   # empty lane


def _explicit_mask_path(monkeypatch):
    """Route the local level step's fused calls through the explicit
    ``smaller_child_mask`` mask (the fused launch given it); returns the
    list of subtracted chunks the step took."""
    from repro_torch.core import tree as tree_mod
    fused = tree_mod.node_histogram_sibling_fused
    stacked = tree_mod.node_histogram_sibling_fused_stacked
    chunks = []

    def one(bins, stats, slot, compute, phist, **kw):
        chunks.append(1)
        return fused(bins, stats, slot, tree_mod.smaller_child_mask(
            slot, kw["num_slots"]), phist, **kw)

    def lanes(bins, stats, slot, compute, phist, **kw):
        chunks.append(1)
        return stacked(bins, stats, slot, tree_mod.smaller_child_mask(
            slot, kw["num_slots"]), phist, **kw)

    monkeypatch.setattr(tree_mod, "node_histogram_sibling_fused", one)
    monkeypatch.setattr(tree_mod, "node_histogram_sibling_fused_stacked",
                        lanes)
    return chunks


def _subtracted_chunks(monkeypatch):
    """Count the local level step's fused calls, passing them on as they
    are."""
    from repro_torch.core import tree as tree_mod
    chunks = []
    for name in ("node_histogram_sibling_fused",
                 "node_histogram_sibling_fused_stacked"):
        def counted(*a, _fn=getattr(tree_mod, name), **kw):
            chunks.append(1)
            return _fn(*a, **kw)
        monkeypatch.setattr(tree_mod, name, counted)
    return chunks


@pytest.mark.parametrize("loss", ["logistic", "softmax"])
def test_pairs_fits_equal_the_explicit_mask_path(cuda, loss, monkeypatch):
    """A 6-round GOSS fit (logistic) and a 3-round 3-class softmax fit grow
    the same trees, field for field, with the smaller children picked in
    the histogram launch as through the explicit mask; the first launches
    one ``pairs`` launch a subtracted chunk and no ``slot_map`` one, and
    each one walk launch a round."""
    from repro_torch.core import GossConfig, GradientBoostedTrees
    from repro_torch.core.tree import TREE_FIELDS
    n_cls = 3 if loss == "softmax" else 2
    cols, y = make_classification(20000, 8, n_cls, seed=4, n_cat_features=2,
                                  missing_frac=0.02)
    table = fit_bins(cols, max_num_bins=64)
    labels = y.astype("int64" if loss == "softmax" else "float32")

    def fit():
        return GradientBoostedTrees(
            n_trees=6 if loss == "logistic" else 3, learning_rate=0.3,
            loss=loss, seed=1,
            goss=GossConfig(0.2, 0.2) if loss == "logistic" else None,
            config=TreeConfig(max_depth=6, task="regression_variance",
                              min_samples_leaf=5, hist_backend="kernel",
                              select_backend="kernel")).fit(
                                  table, labels, device=cuda)

    with monkeypatch.context() as mp:
        chunks = _subtracted_chunks(mp)
        ops.reset_launch_counts()
        got = fit()
        counts = ops.launch_counts()
    assert counts["histogram_pairs"] == counts["histogram_fused"] \
        == len(chunks) > 6
    assert counts["histogram_slot_map"] == 0
    # every round's score update is one walk launch
    assert counts["walk"] == (6 if loss == "logistic" else 3)
    with monkeypatch.context() as mp:
        explicit = _explicit_mask_path(mp)
        ops.reset_launch_counts()
        want = fit()
        assert ops.launch_counts()["histogram_pairs"] == 0
    assert len(explicit) == len(chunks)
    assert len(got.trees) == len(want.trees)
    for ta, tb in zip(got.trees, want.trees):
        assert ta.n_nodes == tb.n_nodes
        for f in TREE_FIELDS:
            assert torch.equal(getattr(ta, f), getattr(tb, f)), f


# -- forest serving: the routed walk and its CUDA graphs --------------------

def _serve_tenant(loss, n_trees, depth, k, seed, dev):
    """A small boosted fit on ``dev`` and its holdout bins."""
    from repro_torch.core import GradientBoostedTrees
    from repro_torch.data import make_regression
    if loss == "logistic":
        cols, y = make_classification(1500, k, 2, seed=seed)
    else:
        cols, y = make_regression(1500, k, seed=seed)
    table = fit_bins(cols, max_num_bins=32)
    ens = GradientBoostedTrees(
        n_trees=n_trees, loss=loss, seed=seed,
        config=TreeConfig(max_depth=depth, task="regression_variance"))
    ens.fit(table, np.asarray(y, np.float32), device=dev)
    return ens, np.asarray(table.bins)


def _own(ens, bins):
    return (ens.predict_proba_device(bins) if ens.loss == "logistic"
            else ens.predict_device(bins)).cpu().numpy()


@pytest.fixture
def serve_tenants(cuda):
    return [_serve_tenant("squared", 4, 4, 5, 0, cuda),
            _serve_tenant("logistic", 6, 3, 5, 1, cuda),
            _serve_tenant("logistic", 3, 5, 3, 2, cuda)]


def _mixed_rows(reg, tenants, n, seed=0):
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, len(tenants), n).astype(np.int32)
    rows = np.stack([reg.pad_bins(tenants[g][1][j:j + 1])[0]
                     for j, g in enumerate(gids)])
    return gids, rows


def test_routed_walk_on_the_card_equals_the_cpu_walk(cuda, serve_tenants):
    """The same tenants in a card registry and a CPU registry: leaf nodes,
    finiteness lanes and pre-link scores bit-equal; on each device the
    linked output is that device's sigmoid of its raw score."""
    from repro_torch.serve import ModelRegistry
    regs = {d: ModelRegistry(capacity=4, device=d) for d in ("cuda", "cpu")}
    for reg in regs.values():
        for i, (ens, _) in enumerate(serve_tenants):
            reg.add(f"t{i}", ens)
    gids, rows = _mixed_rows(regs["cpu"], serve_tenants, 777)
    from repro_torch.serve.registry import _walk_nodes
    nodes = {d: _walk_nodes(r.tables, torch.as_tensor(rows, device=d),
                            torch.as_tensor(gids, device=d),
                            r.num_steps)[0].cpu()
             for d, r in regs.items()}
    assert torch.equal(nodes["cuda"], nodes["cpu"])
    linked = {d: r.predict_checked(gids, rows) for d, r in regs.items()}
    for reg in regs.values():
        reg.tables["link"].zero_()                  # identity link: raw
    raw = {d: r.predict_checked(gids, rows) for d, r in regs.items()}
    assert torch.equal(raw["cuda"][0].cpu(), raw["cpu"][0])
    assert torch.equal(raw["cuda"][1].cpu(), raw["cpu"][1])
    assert torch.equal(linked["cuda"][1].cpu(), linked["cpu"][1])
    logistic = torch.as_tensor(gids != 0, device=cuda)
    want = torch.where(logistic, torch.sigmoid(raw["cuda"][0]),
                       raw["cuda"][0])
    assert torch.equal(linked["cuda"][0], want)


def test_graph_replay_equals_the_eager_walk(cuda, serve_tenants):
    from repro_torch.serve import ModelRegistry
    from repro_torch.serve.batching import serve_graph
    from repro_torch.serve.registry import routed_forest_walk
    reg = ModelRegistry(capacity=4, device=cuda)
    for i, (ens, _) in enumerate(serve_tenants):
        reg.add(f"t{i}", ens)
    for bucket in (1, 64, 512):
        entry = serve_graph(reg, bucket)
        assert entry.graph is not None
        for seed in range(3):
            gids, rows = _mixed_rows(reg, serve_tenants, bucket, seed)
            out, ok = entry.run(gids, rows)
            want, want_ok = routed_forest_walk(
                reg.tables, torch.as_tensor(rows, device=cuda),
                torch.as_tensor(gids, device=cuda), num_steps=reg.num_steps)
            assert np.array_equal(out.view(np.uint32),
                                  want.cpu().numpy().view(np.uint32))
            assert np.array_equal(ok, want_ok.cpu().numpy())


def test_served_outputs_equal_predict_device_at_every_length(cuda,
                                                              serve_tenants):
    """Each tenant served alone and in a mixed flush, at lengths around
    every bucket edge, equals its own prediction over the whole holdout,
    bit for bit: on the card the walk is position-free."""
    from repro_torch.serve import BatchPolicy, ForestServer, ModelRegistry
    reg = ModelRegistry(capacity=4, device=cuda)
    mids = [reg.add(f"t{i}", ens) for i, (ens, _) in enumerate(serve_tenants)]
    server = ForestServer(reg, BatchPolicy(buckets=(1, 8, 64)))
    wants = [_own(ens, bins) for ens, bins in serve_tenants]
    for (ens, bins), mid, want in zip(serve_tenants, mids, wants):
        for n in (1, 2, 7, 8, 9, 63, 64, 65, 150):
            assert np.array_equal(server.predict(mid, bins[:n]), want[:n]), n
    reqs = [(j % 3, server.submit(mids[j % 3],
                                  serve_tenants[j % 3][1][5 * j:5 * j + 5]),
             5 * j) for j in range(30)]
    server.flush()
    for t, p, lo in reqs:
        assert np.array_equal(p.result(), wants[t][lo:lo + 5])
    assert server.compile_count == 3


def test_captured_graphs_see_in_place_registry_writes(cuda, serve_tenants):
    """One capture per bucket; an in-envelope add, a removal and a
    poisoned tenant are all seen by the graphs already captured (no new
    capture, no reallocated table); envelope growth captures anew and
    retires the old signature's graphs."""
    from repro_torch.resilience import poison_tenant
    from repro_torch.serve import (BatchPolicy, ForestServer, ModelRegistry,
                                   NonFiniteOutputError)
    (a, bins_a), (b, bins_b), (c, bins_c) = serve_tenants
    reg = ModelRegistry(capacity=4, tree_cap=6, node_cap=64, device=cuda)
    mid_a = reg.add("a", a)
    server = ForestServer(reg, BatchPolicy(buckets=(8, 64)))
    server.predict(mid_a, bins_a[:5])
    server.predict(mid_a, bins_a[:60])
    assert server.compile_count == 2
    sig, ptrs = reg.shape_sig, {f: t.data_ptr()
                                for f, t in reg.tables.items()}

    mid_b = reg.add("b", b)                          # in the envelope
    assert reg.shape_sig == sig
    assert np.array_equal(server.predict(mid_b, bins_b[:60]),
                          _own(b, bins_b)[:60])
    assert server.compile_count == 2

    poison_tenant(reg, mid_b)
    bad = server.submit(mid_b, bins_b[:5])
    good = server.submit(mid_a, bins_a[:5])
    server.flush()
    assert isinstance(bad.exception(), NonFiniteOutputError)
    assert np.array_equal(good.result(), _own(a, bins_a)[:5])
    assert server.compile_count == 2

    reg.remove("b")
    mid_b2 = reg.add("b", b)                         # repaired, same slot
    assert mid_b2 == mid_b and reg.shape_sig == sig
    assert {f: t.data_ptr() for f, t in reg.tables.items()} == ptrs
    server.breaker.record_success(mid_b)
    assert np.array_equal(server.predict(mid_b, bins_b[:5]),
                          _own(b, bins_b)[:5])
    assert server.compile_count == 2

    big, bins_big = _serve_tenant("squared", 8, 6, 5, 7, cuda)
    mid_big = reg.add("big", big)                    # grows the envelope
    assert reg.shape_sig != sig
    assert np.array_equal(server.predict(mid_big, bins_big[:5]),
                          _own(big, bins_big)[:5])
    assert server.compile_count == 3
    assert set(server._exec) == {(8, reg.shape_sig)}
    assert np.array_equal(server.predict(mid_a, bins_a[:60]),
                          _own(a, bins_a)[:60])
    assert server.compile_count == 4


def test_chaos_scenario_on_the_card(cuda):
    """run_chaos(0) on the card: the reference's census (the committed
    BENCH_chaos.json, read as plain JSON)."""
    import json
    import pathlib
    from repro_torch.resilience import run_chaos
    bench = json.loads((pathlib.Path(__file__).resolve().parents[1]
                        / "BENCH_chaos.json").read_text())
    rep = run_chaos(0, device="cuda")
    assert rep["unhandled"] == 0 and rep["resume_parity_max_abs"] == 0.0
    assert [(o["fault"], o["outcome"]) for o in rep["outcomes"]] == \
        [(o["fault"], o["outcome"]) for o in bench["outcomes"]]
    for k in ("faults_injected", "shed", "served", "retries"):
        assert rep[k] == bench[k], k


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A 1-rank NCCL group over a file store and its 1x1 ("data", "model")
    mesh: the sharded build's every collective, on one card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: NCCL has no CPU mode")
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    tdist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                             world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("dist_kw", [{}, dict(slot_scatter=False),
                                     dict(model_axis=None)])
def test_one_rank_nccl_sharded_build_equals_local(cuda, nccl_mesh, dist_kw):
    """Kernel A's slot_map mode, the reduce and a separate subtraction
    against the fused epilogue: integer counts, so bit for bit."""
    from repro_torch.core import DistConfig, DistributedBuilder
    from repro_torch.core.tree import TREE_FIELDS
    cols, y = make_classification(20000, 8, 3, seed=2, n_cat_features=2,
                                  missing_frac=0.02)
    table = fit_bins(cols, max_num_bins=64)
    cfg = TreeConfig(max_depth=12, chunk_slots=32, hist_backend="kernel",
                     select_backend="kernel")
    local = build_tree(table, y, cfg, n_classes=3, device=cuda)
    ops.reset_launch_counts()
    got = DistributedBuilder(table, cfg, mesh=nccl_mesh,
                             dist=DistConfig(**dist_kw), n_classes=3).build(y)
    launches = ops.launch_counts()
    assert got.n_nodes == local.n_nodes > 50
    for f in TREE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(local, f)), f
    assert launches["histogram_slot_map"] > 0 and launches["split_scan"] > 0
    assert launches["histogram_fused"] == 0


def test_one_rank_nccl_build_batched_equals_local(cuda, nccl_mesh):
    """Integer-valued targets and weights: exact in any order."""
    from repro_torch.core import (DistConfig, DistributedBuilder,
                                  build_trees_batched)
    from repro_torch.core.tree import TREE_FIELDS
    cols, _ = make_classification(20000, 8, 3, seed=2, n_cat_features=2)
    table = fit_bins(cols, max_num_bins=64)
    rng = np.random.default_rng(0)
    z = rng.integers(-3, 4, (4, 20000)).astype(np.float32)
    h = rng.integers(1, 3, (4, 20000)).astype(np.float32)
    cfg = TreeConfig(max_depth=6, chunk_slots=16, task="regression_variance",
                     hist_backend="kernel", select_backend="kernel")
    want, _ = build_trees_batched(table, z, cfg, sample_weight=h,
                                  device=cuda)
    ops.reset_launch_counts()
    got, _ = DistributedBuilder(table, cfg, mesh=nccl_mesh,
                                dist=DistConfig()).build_batched(
                                    z, sample_weight=h)
    assert ops.launch_counts()["histogram_stacked"] > 0
    for g, w in zip(got, want):
        assert g.n_nodes == w.n_nodes > 15
        for f in TREE_FIELDS:
            assert torch.equal(getattr(g, f), getattr(w, f)), f


def _mesh_replay(model, table, labels, dev):
    """The local loop fed the sharded draw on one data shard: each round
    ``goss_sample_sharded_ref`` with the fit's round seed, a local build on
    the selected rows with the same weights, the plain walk."""
    import dataclasses
    from repro_torch.core import build_trees_batched, predict_bins
    from repro_torch.core import walk_class_trees
    from repro_torch.core.forest import _round_seed, goss_sample_sharded_ref
    lo = model._resolve_loss(labels)
    multi = getattr(lo, "is_multiclass", False)
    y = torch.as_tensor(labels, device=dev,
                        dtype=torch.int64 if multi else torch.float32)
    bins = torch.as_tensor(table.bins, device=dev)
    n_num = torch.as_tensor(table.n_num, device=dev)
    m, cfg = len(labels), model.config
    q_top, q_oth = model.goss.shard_quota(m, 1)
    base = lo.base_score(y)
    raw = base[:, None].expand(lo.n_classes, m) if multi else base.expand(m)
    gen = torch.Generator().manual_seed(model.seed)
    lr = torch.tensor(model.learning_rate, device=dev)
    trees = []
    for _ in range(model.n_trees):
        g, h = lo.grad_hess(y, raw)
        z = lo.newton_target(g, h)
        rank = torch.sqrt((g * g * h).sum(0)) if multi else g * torch.sqrt(h)
        w = goss_sample_sharded_ref(rank, _round_seed(gen), d_shards=1,
                                    m_valid=m, q_top=q_top, q_oth=q_oth,
                                    device=dev)
        sel = torch.nonzero(w > 0)[:, 0]
        sub = dataclasses.replace(table, bins=bins[sel])
        if multi:
            rt, arrays = build_trees_batched(
                sub, z[:, sel], cfg, sample_weight=w[sel][None] * h[:, sel],
                device=dev)
            trees.extend(rt)
            raw = raw + lr * walk_class_trees(arrays, bins, n_num,
                                              num_steps=cfg.max_depth)
        else:
            tree = build_tree(sub, z[sel], cfg, sample_weight=(w * h)[sel],
                              device=dev)
            trees.append(tree)
            raw = raw + lr * predict_bins(tree, bins, n_num,
                                          num_steps=cfg.max_depth, device=dev)
    return trees


@pytest.mark.parametrize("loss", ["logistic", "softmax"])
def test_one_rank_nccl_mesh_fit_equals_the_local_loop(cuda, nccl_mesh, loss):
    """The sharded boosting loop on one card: two fits bit-identical, and
    the trees of the local loop fed the same draw (the masked weights
    launch adds the same fixed-point integers as the gathered one)."""
    from repro_torch.core import (DistConfig, GossConfig,
                                  GradientBoostedTrees)
    from repro_torch.core.tree import TREE_FIELDS
    cols, y = make_classification(20000, 8, 3, seed=2, n_cat_features=2)
    table = fit_bins(cols, max_num_bins=64)
    labels = (y if loss == "softmax" else (y > 0)).astype(
        np.int64 if loss == "softmax" else np.float32)

    def model():
        return GradientBoostedTrees(
            n_trees=3, learning_rate=0.3,
            config=TreeConfig(max_depth=5, task="regression_variance",
                              hist_backend="kernel", select_backend="kernel"),
            loss=loss, goss=GossConfig(0.2, 0.2), seed=4)

    ops.reset_launch_counts()
    ens = model().fit(table, labels, mesh=nccl_mesh, dist=DistConfig())
    launches = ops.launch_counts()
    again = model().fit(table, labels, mesh=nccl_mesh, dist=DistConfig())
    loop = _mesh_replay(model(), table, labels, cuda)
    assert len(ens.trees) == len(loop) == (9 if loss == "softmax" else 3)
    for a, b, c in zip(ens.trees, again.trees, loop):
        assert a.n_nodes == b.n_nodes == c.n_nodes > 3
        for f in TREE_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
            assert torch.equal(getattr(a, f)[:a.n_nodes],
                               getattr(c, f)[:c.n_nodes]), f
    assert launches["histogram_weights"] > 0 and launches["split_scan"] > 0
    assert launches["histogram_fused"] == 0
    assert ens.collective_counts[("all_reduce", "goss")][0] == 3


def test_one_rank_nccl_mesh_forest_and_sweep_equal_local(cuda, nccl_mesh):
    """Integer counts: the mesh forest's trees are the local forest's; the
    mesh sweep's grid is the local card sweep's."""
    from repro_torch.core import DistConfig, RandomForest, sweep
    from repro_torch.core.tree import TREE_FIELDS
    cols, y = make_classification(20000, 8, 3, seed=2, n_cat_features=2)
    table = fit_bins(cols, max_num_bins=64)
    cfg = TreeConfig(max_depth=10, hist_backend="kernel",
                     select_backend="kernel")
    local = RandomForest(n_trees=3, config=cfg, seed=1).fit(table, y)
    mesh = RandomForest(n_trees=3, config=cfg, seed=1).fit(
        table, y, mesh=nccl_mesh, dist=DistConfig())
    for a, b in zip(mesh.trees, local.trees):
        assert a.n_nodes == b.n_nodes > 10
        for f in TREE_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    tree = local.trees[0]
    want = sweep(tree, table.bins, y, local.n_nums[0])
    got = sweep(tree, table.bins, y, local.n_nums[0], mesh=nccl_mesh,
                dist=DistConfig())
    for f in ("metric", "n_nodes", "walk_bytes"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


# -- the contract gate (repro_torch.check) on the card ----------------------

from repro_torch.check.contracts import registry as _contracts  # noqa: E402


@pytest.mark.parametrize("name", list(_contracts()))
def test_contract_holds_on_the_card(cuda, name):
    """Each of the eleven contracts recorded on the card under
    ``set_sync_debug_mode("error")``: every rule holds, every part of it
    checked (nothing is n/a on the card)."""
    from repro_torch.check import run_rules
    con = _contracts()[name]
    surface = con.build("cuda")
    assert run_rules(con.rules, surface) == []
    assert [r.unchecked(surface) for r in con.rules] == [None] * len(con.rules)


@pytest.mark.parametrize("s", [16, 1272])
def test_kernel_budget_of_both_kernels_at_the_main_path_shapes(cuda, s):
    """Both kernels at KDD99-10%'s widths: each launch reports the shared
    memory of the plan that launched, within the card's opt-in limit."""
    from repro_torch.check import KernelBudget, record
    optin = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    bins, stats, slot, kw = _case(494021, 41, 257, 5, s, "fused", True, cuda)
    h = record(lambda: ops.histogram(bins, stats, slot, num_slots=s,
                                     n_bins=257, **kw), device="cuda")
    (lc,) = h.launches
    assert lc.kernel == "histogram" and 0 < lc.smem <= optin
    assert not KernelBudget(require_kernel="histogram").check(h)
    hist = torch.rand((s, 41, 257, 5), device=cuda)
    n_num = torch.full((41,), 250, dtype=torch.int32, device=cuda)
    n_cat = torch.full((41,), 7, dtype=torch.int32, device=cuda)
    sc = record(lambda: ops.split_scan(hist, n_num, n_cat), device="cuda")
    (lc,) = sc.launches
    assert lc.kernel == "split_scan" and lc.smem == 257 * 5 * 4 <= optin
    assert not KernelBudget(require_kernel="split_scan").check(sc)


# -- the LM serving path (models/, serve.serve): no kernel of its own ---------


def _lm(arch, device, dtype):
    """A smoke model drawn on the CPU from a seeded generator, then moved."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import model as M
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=dtype)
    return M.init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(device)


@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b",
                                  "xlstm_125m", "llama4_maverick_400b_a17b"])
def test_lm_decode_on_the_card_reads_nothing_back(cuda, arch):
    """Prefill, greedy decode and temperature sampling run under
    set_sync_debug_mode("error"): no step copies a value to the host."""
    from repro_torch.serve import serve as S
    model = _lm(arch, cuda, "bfloat16")
    g = torch.Generator(device=cuda).manual_seed(1)
    prompt = torch.randint(0, model.cfg.vocab, (2, 6), generator=g,
                           device=cuda, dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = S.prefill(model, prompt, 6 + 8 + 1)
        greedy, cache = S.decode_loop(model, logits, cache, 8)
        sampled, _ = S.decode_loop(model, *S.prefill(model, prompt, 15), 8,
                                   temperature=0.7, generator=g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(cache["index"]) == 14
    for toks in (greedy, sampled):
        assert toks.shape == (2, 8) and toks.device.type == "cuda"
        assert 0 <= int(toks.min()) and int(toks.max()) < model.cfg.vocab


@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b"])
def test_lm_logits_on_the_card_equal_the_cpu(cuda, arch):
    """An attention arch and a recurrent one in f32: forward and three
    decode steps on the card within 1e-3 of the same weights on the CPU
    (f32 products in another order; k, v cached in bf16)."""
    from repro_torch.models import model as M
    outs = {}
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, size=(2, 12)).astype(np.int32)
    for dev in (torch.device("cpu"), cuda):
        model = _lm(arch, dev, "float32")
        t = torch.from_numpy(toks).to(dev)
        with torch.no_grad():
            got = [M.forward(model, {"tokens": t}).cpu()]
        cache = M.init_cache(model.cfg, 2, 8, dev)
        for s in range(3):
            lg, cache = M.decode_step(model, t[:, s:s + 1], cache)
            got.append(lg.cpu())
        outs[dev.type] = got
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-3)


# -- LM training (train/, launch.train): no kernel of its own -----------------


def _train_pair(arch, device, **kw):
    """A smoke train state in f32 drawn on the CPU from a seeded generator,
    carried to ``device``, and a seeded batch there."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.train import init_train_state
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32", **kw)
    tree = M.train_state_to_numpy(init_train_state(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    batch = launch_train.synthetic_lm_batch(cfg, 2, 16, 0, device="cpu")
    return (M.train_state_from_numpy(tree, cfg, device),
            {k: v.to(device) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b",
                                  "xlstm_125m", "arctic_480b",
                                  "paligemma_3b", "hubert_xlarge"])
def test_lm_train_step_on_the_card_equals_the_cpu(cuda, arch, monkeypatch):
    """One train step (lr 3e-4) from the same weights and batch, f32
    activations: loss within rtol 1e-4; grad norm within rtol 1e-4 and new
    parameters within 1e-4 where the step is well conditioned
    (tests/test_torch_train.py), 2 * lr + 1e-4 anywhere -- unless a value
    of the xLSTM normaliser max(|n|, 1) lies on the other side of its kink
    on the card (its gradient is then another function), which is
    counted."""
    from repro_torch.models import xlstm as XL
    from repro_torch.train import make_train_step
    out, seen, normalizer = [], [], XL._normalizer
    for dev in (torch.device("cpu"), cuda):
        state, batch = _train_pair(arch, dev)
        p0 = [p.detach().cpu().clone() for p in state.model.parameters()]
        rec = []
        seen.append(rec)
        monkeypatch.setattr(XL, "_normalizer", lambda n, rec=rec: (
            rec.append(n.detach().cpu()), normalizer(n))[1])
        state, m = make_train_step(state.model.cfg)(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    [p.detach().cpu() for p in state.model.parameters()]))
    (lc, nc, pc), (lg, ng, pg) = out
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    if any(((a.abs() >= 1) != (b.abs() >= 1)).any()
           for a, b in zip(*seen)):
        return
    assert abs(ng - nc) <= 1e-4 * abs(nc)
    for a, r, q in zip(p0, pc, pg):
        u = (a - r) / 3e-4 - 0.1 * a
        well = u.abs() >= 0.99
        torch.testing.assert_close(q[well], r[well], rtol=0, atol=1e-4)
        assert float((q - r).abs().max()) <= 2 * 3e-4 + 1e-4


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b"])
def test_lm_train_remat_on_the_card(cuda, arch, policy):
    """Remat on against off on the card: the same loss bit for bit (the
    forward runs the same products), gradients within 1e-6 (the embedding
    gather's backward adds with float atomics, in any order)."""
    from repro_torch.train import train_step as T
    got = {}
    for remat in (False, True):
        state, batch = _train_pair(arch, cuda, remat=remat,
                                   remat_policy=policy)
        got[remat] = T.loss_and_grads(state.model, batch)
    assert torch.equal(got[True][0], got[False][0])
    for n, g in got[False][1].items():
        torch.testing.assert_close(got[True][1][n], g, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b",
                                  "xlstm_125m", "arctic_480b"])
def test_lm_train_step_reads_nothing_back(cuda, arch):
    """A train step (remat on, bf16 activations as configured) under
    set_sync_debug_mode("error"): nothing in the step copies a value to
    the host; loss and grad norm stay on the card."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.train import init_train_state, make_train_step
    cfg = dataclasses.replace(configs.get_smoke(arch), remat=True)
    state = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    batch = launch_train.synthetic_lm_batch(cfg, 2, 16, 0, device=cuda)
    step = make_train_step(cfg, loss_chunk=4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert m["loss"].device.type == "cuda"
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert int(state.opt["step"]) == 1


# ---------------------------------------------------------------------------
# fault F2: float sums by atomics on the LM path, and the sharded LM on a
# 1-rank NCCL mesh
# ---------------------------------------------------------------------------

def test_embedding_gradient_is_order_free_on_the_card(cuda):
    """Two backward passes over a batch of heavily repeated token ids give
    the same embedding gradient bit for bit: the gather's backward (an
    index_add_ over the ids) and the tied unembedding's, summed."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    cfg = dataclasses.replace(configs.get_smoke("smollm_360m"),
                              dtype="float32")
    model = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    ids = torch.randint(0, cfg.vocab, (4,), generator=g, device=cuda)
    pick = torch.randint(0, 4, (8, 256), generator=g, device=cuda)
    batch = {"tokens": ids[pick].int(), "labels": ids[pick.roll(1, 1)].int()}
    grads = [T.loss_and_grads(model, batch)[1]["embed"] for _ in range(2)]
    assert torch.equal(grads[0], grads[1])
    table = model.embed.detach().clone().requires_grad_(True)
    w = torch.randn((8, 256, cfg.d_model), generator=g, device=cuda)
    from repro_torch.models import layers as L
    lookups = []
    for _ in range(2):
        (gt,) = torch.autograd.grad((L.embed(batch["tokens"], table) * w)
                                    .sum(), table)
        lookups.append(gt)
    assert torch.equal(lookups[0], lookups[1])


@pytest.mark.parametrize("path", ["plain", "local", "a2a"])
def test_moe_combine_is_order_free_on_the_card(cuda, nccl_mesh, path):
    """arctic-smoke's MoE block (top-2: every token is added from two
    experts) run twice gives the same output bit for bit, on the plain
    path and on both mesh combines (a 1x1 NCCL mesh)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as SH
    cfg = dataclasses.replace(configs.get_smoke("arctic_480b"),
                              dtype="float32")
    g = torch.Generator(device=cuda).manual_seed(2)
    p = MOE.init_moe(g, cfg, torch.float32, cuda)
    b, t = (4, 32) if path == "a2a" else (2, 8)      # a2a from 64 tokens
    x = torch.randn((b, t, cfg.d_model), generator=g, device=cuda)
    try:
        if path != "plain":
            SH.set_activation_axes(mesh_axes(nccl_mesh), nccl_mesh)
        outs = [MOE.moe_block(p, x, cfg) for _ in range(2)]
        if path != "plain":
            tags = {k for k in SH.COMM.counts}
            want = ("all_to_all_single" if path == "a2a" else "all_reduce",
                    "moe")
            assert want in tags, tags
    finally:
        SH.set_activation_axes(None, None)
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0], MOE._moe_block_plain(p, x, cfg),
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b",
                                  "xlstm_125m", "llama4_maverick_400b_a17b"])
def test_one_rank_nccl_lm_mesh_equals_no_mesh(cuda, nccl_mesh, arch):
    """The sharded LM on a 1x1 NCCL mesh (every collective of size 1): the
    forward logits, a decode step and one train step equal the no-mesh
    path bit for bit."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models import model as M
    from repro_torch.models import placement as PL
    from repro_torch.models import sharding as SH
    from repro_torch.train import init_train_state, make_train_step
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    batch = launch_train.synthetic_lm_batch(cfg, 2, 16, 0, device=cuda)
    got = {}
    for meshed in (False, True):
        state = init_train_state(
            cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
        try:
            if meshed:
                SH.set_activation_axes(mesh_axes(nccl_mesh), nccl_mesh)
                state = PL.shard_train_state(state)
            with torch.no_grad():
                logits = M.forward(state.model, batch)
                cache = M.init_cache(cfg, 2, 4, cuda)
                dec, _ = M.decode_step(state.model, batch["tokens"][:, :1],
                                       cache)
            state, m = make_train_step(cfg)(state, batch)
            params = [p.detach().clone() for p in
                      state.model.parameters()]
            if meshed:
                assert any(c[0] for c in SH.COMM.counts.values())
        finally:
            SH.set_activation_axes(None, None)
        got[meshed] = (logits, dec, m["loss"], m["grad_norm"], params)
    for a, b in zip(got[False][:4], got[True][:4]):
        assert torch.equal(a, b)
    for a, b in zip(got[False][4], got[True][4]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the dry-run analysis: a fake CPU recording against a real step on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b",
                                  "xlstm_125m", "arctic_480b",
                                  "paligemma_3b", "hubert_xlarge"])
def test_dryrun_fake_cpu_counts_equal_the_card(cuda, arch):
    """``launch.analysis.count`` of the smoke config's forward and train
    step (batch 2, seq 16, no mesh): on fake CPU tensors and on real card
    tensors the same FLOPs, bytes and memory counts, as integers (the
    phase ``dryrun`` check (ii) at smoke width)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs
    from repro_torch.launch import analysis, specs
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.train import init_train_state, make_train_step
    cfg = configs.get_smoke(arch)
    batch = launch_train.synthetic_lm_batch(cfg, 2, 16, 0, device=cuda)
    step = make_train_step(cfg)
    fwd_in = {k: v for k, v in batch.items() if k != "labels"}

    def counted(state, b, f):
        with torch.no_grad():
            fwd = analysis.count(M.forward, state.model, f)
        return fwd, analysis.count(step, state, b)

    state = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    real = counted(state, batch, fwd_in)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    meta = {k: v.to("meta") for k, v in batch.items()}
    fbatch = specs.fake_inputs(meta, mode)
    fstate = specs.fake_state(cfg, mode)
    with mode:
        fake = counted(fstate, fbatch,
                       {k: v for k, v in fbatch.items() if k != "labels"})
    for r, f in zip(real, fake):
        for k in ("flops", "bytes_accessed", "ops", "memory"):
            assert r[k] == f[k], k


# -- the linear scan (the RG-LRU's and the sLSTM's recurrence) ---------------

SCAN_SHAPES = [(1, 1, 1), (3, 7, 5), (2, 129, 70), (8, 128, 1536),
               (8, 128, 2560), (2, 4096, 2560)]


def _scan_inputs(shape, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(shape, generator=g, device=dev) * 0.95 + 0.049
    return (a, torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev))


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_linear_scan_kernel_equals_plain_bit_for_bit(cuda, shape):
    """Forward and backward kernels against the plain loops, bit for bit
    (one rounded product and one rounded sum a step in both), and two
    launches equal."""
    from repro_torch.kernels.linear_scan import (linear_scan_backward_cuda,
                                                 linear_scan_backward_plain,
                                                 linear_scan_cuda,
                                                 linear_scan_plain)
    a, b, g = _scan_inputs(shape, cuda, seed=sum(shape))
    ops.reset_launch_counts()
    h = linear_scan_cuda(a, b)
    assert torch.equal(h, linear_scan_plain(a, b))
    assert torch.equal(h, linear_scan_cuda(a, b))
    da, db = linear_scan_backward_cuda(a, h, g)
    pa, pb = linear_scan_backward_plain(a, h, g)
    assert torch.equal(da, pa) and torch.equal(db, pb)
    da2, db2 = linear_scan_backward_cuda(a, h, g)
    assert torch.equal(da, da2) and torch.equal(db, db2)
    assert ops.launch_counts()["linear_scan"] == 2
    assert ops.launch_counts()["linear_scan_backward"] == 2


@pytest.mark.parametrize("shape", [(3, 7, 5), (8, 128, 1536),
                                   (2, 300, 1540)])
def test_linear_scan_op_gradients_equal_the_loop_on_the_card(cuda, shape):
    from repro_torch.kernels.linear_scan import linear_scan
    from repro_torch.kernels.ref import linear_scan_loop
    a, b, g = _scan_inputs(shape, cuda, seed=1)
    leaves = (a.requires_grad_(), b.requires_grad_())
    got = torch.autograd.grad(linear_scan(*leaves), leaves, g)
    want = torch.autograd.grad(linear_scan_loop(*leaves), leaves, g)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


# edge shapes of the launch plan: T = 1 and a stage's length +- 1 (31 and
# 33 for 32-step stages; 257, 1,023 and 1,025 end on a stage of 1, 127
# and 1 steps of the 64-, 128- and 256-step stages the plan picks there);
# D = 1, 33, 1,535 (not multiples of 4: the TMA's 16-byte rows do not
# fit, so the short walk at any T) and 2,560; B * D below the SMs' 132
# tiles
SCAN_EDGES = [(1, 1, 2560), (2, 31, 64), (2, 33, 64), (1, 257, 64),
              (1, 1023, 64), (1, 1025, 64), (3, 100, 1), (3, 100, 33),
              (2, 70, 1535), (2, 65, 2560), (1, 300, 70)]


def _scan_bits(a, b, g, pf=None, pb=None):
    """Both kernels against the plain loops bit for bit, and two launches
    of each equal."""
    from repro_torch.kernels.linear_scan import (linear_scan_backward_cuda,
                                                 linear_scan_backward_plain,
                                                 linear_scan_cuda,
                                                 linear_scan_plain)
    h = linear_scan_cuda(a, b, pf)
    assert torch.equal(h, linear_scan_plain(a, b))
    assert torch.equal(h, linear_scan_cuda(a, b, pf))
    da, db = linear_scan_backward_cuda(a, h, g, pb)
    pa, pb_ = linear_scan_backward_plain(a, h, g)
    assert torch.equal(da, pa) and torch.equal(db, pb_)
    da2, db2 = linear_scan_backward_cuda(a, h, g, pb)
    assert torch.equal(da, da2) and torch.equal(db, db2)


@pytest.mark.parametrize("path", ["planned", "staged", "walk"])
@pytest.mark.parametrize("shape", SCAN_EDGES)
def test_linear_scan_edges_bit_for_bit(cuda, shape, path):
    """Each edge shape by the plan's own path and by each path forced (the
    staged walk where D allows it)."""
    from repro_torch.kernels.linear_scan import scan_plan
    short_t = dict(planned=None, staged=0, walk=shape[1] + 1)[path]
    plans = (None, None) if short_t is None else (
        scan_plan(shape, short_t=short_t),
        scan_plan(shape, backward=True, short_t=short_t))
    if path == "staged":
        assert plans[0].staged == (shape[2] % 4 == 0)
    _scan_bits(*_scan_inputs(shape, cuda, seed=sum(shape)), *plans)


@pytest.mark.parametrize("dt", [-1, 0, 1])
@pytest.mark.parametrize("backward", [False, True])
def test_linear_scan_short_t_threshold(cuda, backward, dt):
    """T at a direction's short-T threshold +- 1: the plans' paths, bit
    for bit both ways."""
    from repro_torch.kernels.linear_scan import (SHORT_T, SHORT_T_BACKWARD,
                                                 scan_plan)
    shape = (2, (SHORT_T_BACKWARD if backward else SHORT_T) + dt, 96)
    assert scan_plan(shape, backward=backward).staged == (dt >= 0)
    _scan_bits(*_scan_inputs(shape, cuda, seed=dt + 5))


def test_linear_scan_unaligned_operands(cuda):
    """Operands 4 bytes off a 16-byte boundary (D a multiple of 4): the
    wrappers plan the short walk, bit for bit; a staged plan is refused."""
    from repro_torch.kernels.linear_scan import (linear_scan_backward_cuda,
                                                 linear_scan_cuda, scan_plan)
    shape = (2, 75, 64)
    a, b, g = (x.reshape(-1) for x in _scan_inputs(shape, cuda, seed=9))
    a, b, g = (torch.cat([x[:1], x])[1:].view(shape) for x in (a, b, g))
    assert a.data_ptr() % 16 and a.is_contiguous()
    ops.reset_launch_counts()
    _scan_bits(a, b, g)
    assert ops.launch_counts()["linear_scan"] == 2
    staged = scan_plan(shape), scan_plan(shape, backward=True)
    assert staged[0].staged and staged[1].staged
    with pytest.raises(RuntimeError, match="launch failed"):
        linear_scan_cuda(a, b, staged[0])
    with pytest.raises(RuntimeError, match="launch failed"):
        linear_scan_backward_cuda(a, b, g, staged[1])
    torch.cuda.synchronize()


def test_linear_scan_refuses_on_the_card(cuda):
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_cuda
    a, b, _ = _scan_inputs((2, 5, 3), cuda)
    with pytest.raises(TypeError):
        linear_scan_cuda(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        linear_scan(a.transpose(0, 2).contiguous().transpose(0, 2), b)
    with pytest.raises(ValueError):
        linear_scan(a, b.cpu())
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# kernel D: the score walk
# ---------------------------------------------------------------------------

def _walk_case(dev, *, m, k, trees=1, depth=10, slots=2000, n_bins=16,
               per_tree=False, seed=0, leaf_p=0.15):
    """Seeded trees stacked through ``stack_trees`` (each its own width, so
    the narrower ones are padded), codes with categorical and missing ids
    (``>= n_num``) on the card; returns (fields, bins, n_num, n_nodes)."""
    import types

    from repro_torch.core.predict import WALK_FIELDS, stack_trees
    made = [ref.random_tree(seed + t, k=k, n_bins=n_bins, depth=depth,
                            slots=slots - 3 * (t % 4), leaf_p=leaf_p,
                            root_count=1 << 14) for t in range(trees)]
    fields = stack_trees([types.SimpleNamespace(**f) for f, _ in made])
    fields = {f: fields[f].to(dev) for f in WALK_FIELDS}
    rng = np.random.default_rng(seed)
    n_num = rng.integers(0, n_bins + 1, (trees, k) if per_tree else (k,))
    bins = rng.integers(0, n_bins + 3, (m, k))
    return (fields, torch.as_tensor(bins, dtype=torch.int32, device=dev),
            torch.as_tensor(n_num, dtype=torch.int32, device=dev),
            max(n for _, n in made))


def _walk_both(fields, bins, n_num, **kw):
    """The kernel's labels and the plain walk's on the card, launch
    checked."""
    from repro_torch.kernels.walk import walk_plain
    before = ops.launch_counts()["walk"]
    got = ops.walk(fields, bins, n_num, **kw)
    assert ops.launch_counts()["walk"] == before + (
        1 if got.numel() else 0)
    kw.pop("n_nodes", None)
    steps = min(kw.pop("num_steps"), max(kw.pop("max_depth", 1 << 30) - 1,
                                         0))
    want = walk_plain(fields, bins, n_num, steps=steps, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    return got, want


@pytest.mark.parametrize("dmax,smin,mcw", [
    (1 << 30, 0, 0.0), (4, 0, 0.0), (1, 0, 0.0), (0, 0, 0.0),
    (1 << 30, "node", 0.0), (1 << 30, 0, "child"), (7, "node", "child"),
    (1 << 30, 0, 2.5), (1 << 30, 0, -1.0), (1 << 30, 1 << 20, 0.0)])
def test_walk_kernel_runtime_limits_bit_for_bit(cuda, dmax, smin, mcw):
    """One tree under predict_bins' limits; ``node`` is a node's own count
    (the ``>=`` edge), ``child`` a child's count (the ``>`` edge)."""
    fields, bins, n_num, n = _walk_case(cuda, m=20000, k=7)
    count = fields["count"][0].cpu()
    smin = int(count[2]) if smin == "node" else smin
    mcw = float(count[3]) if mcw == "child" else mcw
    for n_nodes in (n, None):
        got, want = _walk_both(fields, bins, n_num, num_steps=12,
                               n_nodes=n_nodes, max_depth=dmax,
                               min_samples_split=smin, min_child_weight=mcw)
        assert torch.equal(got, want)


@pytest.mark.parametrize("per_tree", [False, True])
@pytest.mark.parametrize("trees,slots", [(5, 300), (40, 160)])
def test_walk_kernel_many_trees_bit_for_bit(cuda, trees, slots, per_tree):
    """C stacked trees of unequal widths (``stack_trees`` padding), with
    ``n_num [K]`` and ``[C, K]``; 40 trees of 160 slots are too many to
    stage, so their fields are read from device memory."""
    fields, bins, n_num, n = _walk_case(cuda, m=30001, k=9, trees=trees,
                                        slots=slots, per_tree=per_tree)
    for n_nodes in (n, None):
        got, want = _walk_both(fields, bins, n_num, num_steps=10,
                               n_nodes=n_nodes)
        assert torch.equal(got, want)


@pytest.mark.parametrize("steps", [1, 3, 25])
@pytest.mark.parametrize("m", [0, 1, 255, 257, 100003])
def test_walk_kernel_rows_and_steps(cuda, m, steps):
    fields, bins, n_num, n = _walk_case(cuda, m=m, k=5, trees=2)
    got, want = _walk_both(fields, bins, n_num, num_steps=steps, n_nodes=n)
    assert got.shape == (2, m)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 7, 28, 41, 47, 48, 300])
def test_walk_kernel_feature_counts(cuda, k):
    """Rows of 1 to 47 codes are staged in shared memory, 48 and more are
    read from device memory (the odd pitch passes 48 ints)."""
    fields, bins, n_num, n = _walk_case(cuda, m=5000, k=k, trees=3,
                                        per_tree=True)
    got, want = _walk_both(fields, bins, n_num, num_steps=10, n_nodes=n)
    assert torch.equal(got, want)


def test_walk_kernel_boosted_tree_slots(cuda):
    """A boosted tree's 4,194,304 node slots holding 511 nodes, walked with
    and without ``n_nodes``: staged and read from device memory alike."""
    fields, bins, n_num, n = _walk_case(cuda, m=50000, k=28, depth=9,
                                        slots=1 << 22, n_bins=255, leaf_p=0.0)
    assert n == 511
    for n_nodes in (n, None):
        got, want = _walk_both(fields, bins, n_num, num_steps=9,
                               n_nodes=n_nodes)
        assert torch.equal(got, want)


def test_walk_through_predict_equals_the_cpu(cuda):
    """predict_bins and walk_class_trees on the card equal their CPU
    plain versions on a tree built on the card."""
    from repro_torch.core.predict import (WALK_FIELDS, predict_bins,
                                          walk_class_trees)
    cols, y = make_classification(3000, 6, 3, seed=3, n_cat_features=2,
                                  missing_frac=0.05)
    table = fit_bins(cols, max_num_bins=32)
    tree = build_tree(table, y, TreeConfig(max_depth=9), n_classes=3,
                      device=cuda)
    ops.reset_launch_counts()
    for kw in (dict(), dict(max_depth=4, min_samples_split=30,
                            min_child_weight=3.0)):
        got = predict_bins(tree, table.bins, table.n_num, device=cuda, **kw)
        want = predict_bins(tree, table.bins, table.n_num, device="cpu",
                            **kw)
        assert torch.equal(got.cpu(), want)
    arrays = {f: torch.stack([getattr(tree, f)] * 2) for f in WALK_FIELDS}
    got = walk_class_trees(arrays, table.bins, table.n_num, num_steps=9,
                           n_nodes=tree.n_nodes)
    want = walk_class_trees({f: v.cpu() for f, v in arrays.items()},
                            table.bins, table.n_num, num_steps=9)
    assert torch.equal(got.cpu(), want)
    assert ops.launch_counts()["walk"] == 3


def test_walk_wrapper_refuses(cuda):
    from repro_torch.kernels.walk import walk_cuda
    fields, bins, n_num, n = _walk_case(cuda, m=300, k=5)
    kw = dict(num_steps=5, n_nodes=n)
    with pytest.raises(ValueError, match="contiguous"):
        ops.walk(fields, bins.t().contiguous().t(), n_num, **kw)
    with pytest.raises(TypeError):
        ops.walk(fields, bins.long(), n_num, **kw)
    with pytest.raises(ValueError):
        ops.walk(fields, bins, n_num.cpu(), **kw)
    with pytest.raises(ValueError):
        walk_cuda({f: v.cpu() for f, v in fields.items()}, bins, n_num,
                  steps=5)
    with pytest.raises(ValueError, match="n_nodes"):
        ops.walk(fields, bins, n_num, num_steps=5, n_nodes=1 << 22)
    torch.cuda.synchronize()
