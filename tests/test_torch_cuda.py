"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``gpu``) and skips without
one; the decision is taken inside the ``cuda`` fixture, never at import.
Run on the card with ``pytest -m gpu tests/test_torch_cuda.py``.  This file
imports torch and repro_torch only.

Tolerances: integer-count stats exact (f32 integers below 2**24 are exact
in any order); float stats rtol 1e-5; split-scan scores rtol/atol 1e-5,
bin and op equal wherever the best candidate is unique."""
import pytest
import torch

from repro_torch.core import TreeConfig, build_tree, fit_bins
from repro_torch.data import make_classification
from repro_torch.kernels import ops, ref
from repro_torch.kernels.histogram import histogram_cuda, histogram_plain
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
MODES = ["plain", "weights", "slot_map", "fused"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(m, k, b, c, s, mode, integer, dev, seed=0):
    """Inputs made on the card from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_raw = 2 * s if mode in ("slot_map", "fused") else s

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
    if mode == "fused":
        kw["phist"] = ints(0, 9, (s, k, b, c)).float()
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
                                   "histogram_fused": 1, "split_scan": 1}
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
