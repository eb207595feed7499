"""Port parity for the kernel modules on the CPU: the plain versions of the
CUDA kernels (what ``repro_torch.kernels.ops`` runs on CPU tensors) against
the JAX package's Pallas kernels in interpret mode (``repro.kernels.ops``),
and the torch oracles against the JAX oracles.

Integer-count stats must agree exactly; float stats to rtol/atol 1e-5 (the
summation order differs).  The split scan follows tests/test_kernels.py:
scores to rtol/atol 1e-5, bin and op equal wherever the best is unique."""
import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops as tops, ref as tref

SHAPES = [
    # (M, K, B, C, S) -- the SHAPES of tests/test_kernels.py
    (64, 1, 4, 2, 1),
    (300, 5, 17, 4, 6),
    (128, 3, 33, 2, 9),
    (1000, 2, 8, 26, 3),
    (37, 7, 5, 3, 2),
]
MODES = ["plain", "weights", "slot_map", "fused"]


def _case(m, k, b, c, s, mode, integer, seed=0):
    """numpy inputs for one histogram call; ``s`` counts output slots (or
    packed pairs in fused mode)."""
    rng = np.random.default_rng(seed)
    n_raw = 2 * s if mode in ("slot_map", "fused") else s
    bins = rng.integers(0, b, size=(m, k)).astype(np.int32)
    if integer:
        stats = np.eye(c, dtype=np.float32)[rng.integers(0, c, size=m)]
    else:
        stats = rng.uniform(size=(m, c)).astype(np.float32)
    # slot -1 rows, and in-range raw slots past n_raw, must both be dropped
    slot = rng.integers(-1, n_raw + 1, size=m).astype(np.int32)
    kw = dict(num_slots=s, n_bins=b)
    if mode == "weights":
        kw["weights"] = (rng.integers(1, 4, size=m) if integer
                         else rng.uniform(0.5, 2.0, size=m)).astype(np.float32)
    if mode in ("slot_map", "fused"):
        side = rng.integers(0, 2, size=s)
        compute = np.zeros(n_raw, dtype=bool)
        compute[2 * np.arange(s) + side] = True
        kw["slot_map"] = np.where(compute, np.arange(n_raw) // 2,
                                  -1).astype(np.int32)
    if mode == "fused":
        kw["phist"] = rng.integers(0, 9, size=(s, k, b, c)).astype(np.float32)
        kw["side"] = (1 - side).astype(np.int32)
    return bins, stats, slot, kw


def _run_both(bins, stats, slot, kw):
    got = tops.histogram(torch.from_numpy(bins), torch.from_numpy(stats),
                         torch.from_numpy(slot),
                         **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                                else v) for k, v in kw.items()})
    want = jops.histogram(jnp.asarray(bins), jnp.asarray(stats),
                          jnp.asarray(slot),
                          **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                 else v) for k, v in kw.items()})
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,b,c,s", SHAPES)
def test_histogram_plain_matches_pallas_exact_counts(m, k, b, c, s, mode):
    got, want = _run_both(*_case(m, k, b, c, s, mode, integer=True))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,b,c,s", SHAPES[1:3])
def test_histogram_plain_matches_pallas_float_stats(m, k, b, c, s, mode):
    got, want = _run_both(*_case(m, k, b, c, s, mode, integer=False, seed=1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _scan_case(s, k, b, c, seed, moment=False):
    rng = np.random.default_rng(seed)
    if moment:
        hist = np.zeros((s, k, b, 3), np.float32)
        cnt = rng.poisson(5, size=(s, k, b)).astype(np.float32)
        mu = rng.normal(size=(s, k, b)).astype(np.float32)
        hist[..., 0], hist[..., 1] = cnt, cnt * mu
        hist[..., 2] = cnt * (mu ** 2 + 0.1)
    else:
        hist = rng.poisson(2, size=(s, k, b, c)).astype(np.float32)
    n_num = rng.integers(0, b, size=k).astype(np.int32)
    n_cat = np.minimum(rng.integers(0, 4, size=k), b - n_num).astype(np.int32)
    return hist, n_num, n_cat


def _assert_scan_equal(got, want):
    s1, b1, o1 = (t.numpy() for t in got)
    s0, b0, o0 = (np.asarray(t) for t in want)
    np.testing.assert_allclose(s1, s0, rtol=1e-5, atol=1e-5)
    unique = np.isclose(s1, s0, atol=1e-6)
    np.testing.assert_array_equal(b1[unique], b0[unique])
    np.testing.assert_array_equal(o1[unique], o0[unique])


@pytest.mark.parametrize("heur", ["info_gain", "gini", "chi_square", "sse"])
@pytest.mark.parametrize("m,k,b,c,s", SHAPES)
def test_split_scan_plain_matches_pallas(m, k, b, c, s, heur):
    hist, n_num, n_cat = _scan_case(s, k, b, c, seed=m, moment=heur == "sse")
    got = tops.split_scan(torch.from_numpy(hist), torch.from_numpy(n_num),
                          torch.from_numpy(n_cat), heuristic=heur, min_leaf=2)
    want = jops.split_scan(jnp.asarray(hist), jnp.asarray(n_num),
                           jnp.asarray(n_cat), heuristic=heur, min_leaf=2)
    _assert_scan_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_torch_oracles_match_jax_oracles(weighted):
    m, k, b, c, p = 300, 5, 17, 4, 6
    bins, stats, slot, kw = _case(m, k, b, c, p, "fused", integer=False, seed=2)
    w = np.random.default_rng(3).uniform(0.5, 2, size=m).astype(np.float32)
    w = w if weighted else None
    T, J = torch.from_numpy, jnp.asarray
    tw = None if w is None else T(w)
    jw = None if w is None else J(w)
    np.testing.assert_allclose(
        tref.histogram_ref(T(bins), T(stats), T(slot), num_slots=2 * p,
                           n_bins=b, weights=tw).numpy(),
        np.asarray(jref.histogram_ref(J(bins), J(stats), J(slot),
                                      num_slots=2 * p, n_bins=b, weights=jw)),
        rtol=1e-5, atol=1e-5)
    args = (kw["slot_map"], kw["phist"], kw["side"])
    np.testing.assert_allclose(
        tref.sibling_ref(T(bins), T(stats), T(slot), *map(T, args),
                         num_pairs=p, n_bins=b, weights=tw).numpy(),
        np.asarray(jref.sibling_ref(J(bins), J(stats), J(slot), *map(J, args),
                                    num_pairs=p, n_bins=b, weights=jw)),
        rtol=1e-5, atol=1e-5)
    hist, n_num, n_cat = _scan_case(4, k, b, c, seed=5)
    _assert_scan_equal(
        tref.split_scan_ref(T(hist), T(n_num), T(n_cat), heuristic="gini"),
        jref.split_scan_ref(J(hist), J(n_num), J(n_cat), heuristic="gini"))
