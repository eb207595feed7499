"""Port parity for resilience (repro_torch.resilience, the serving
degradation surface and the KDD99 loader) on the CPU.

The port's counterpart of the single-device tests in
tests/test_resilience.py: bounded admission, deadline shedding under an
injected clock, retry with exponential backoff and typed exhaustion, the
per-tenant circuit breaker (quarantine, isolation, half-open recovery,
disabled), fit-entry rejection of non-finite labels and weights, the
KDD99 download's retries and payload check, and the chaos scenario's
guard flips.  Against the reference: ``make_plan`` draws the same
``FaultPlan`` for the same seed, the port's ``run_chaos(0)`` gives every
fault the reference's outcome and the same counts, and ``_parse_raw`` /
the cache lookup give the same arrays.

The resume tests of tests/test_resilience.py (in-process and SIGKILL on
one device) have their port counterparts in tests/test_torch_checkpoint.py.
The mesh SIGKILL resume (``test_sigkill_then_resume_mesh``) waits for the
port's sharded build.
"""
import dataclasses
import gzip
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.data import kdd99 as jkdd99
from repro.resilience import make_plan as jmake_plan
from repro.resilience import run_chaos as jrun_chaos
pytest.importorskip("torch")
from repro_torch.checkpoint import (CheckpointCorruptError, RoundCheckpointer,
                                    restore_round_state)
from repro_torch.core import (GossConfig, GradientBoostedTrees, RandomForest,
                              TreeConfig, fit_bins)
from repro_torch.data import kdd99, make_regression
from repro_torch.resilience import (PreemptedError, SkewClock,
                                    TransientFaults, chain,
                                    corrupt_checkpoint, make_plan,
                                    poison_labels, poison_tenant,
                                    preempt_at_round, run_chaos)
from repro_torch.serve import (AdmissionPolicy, BatchPolicy, CircuitBreaker,
                               DeadlineExceededError, ForestServer,
                               ModelRegistry, NonFiniteOutputError,
                               QueueFullError, RetriesExhaustedError,
                               TenantUnavailableError)

CPU = "cpu"


def _binary_problem(m=400, k=5, seed=11):
    cols, y = make_regression(m, k, seed=seed)
    table = fit_bins(cols, max_num_bins=32)
    yb = (np.asarray(y) > np.median(y)).astype(np.float32)
    return table, yb


def _mk_gbt(seed=9, n_trees=5):
    return GradientBoostedTrees(
        n_trees=n_trees, learning_rate=0.3,
        config=TreeConfig(max_depth=3, task="regression_variance"),
        goss=GossConfig(0.3, 0.2), loss="logistic", seed=seed)


def _mk_squared(seed=9, n_trees=4):
    return GradientBoostedTrees(
        n_trees=n_trees, learning_rate=0.3,
        config=TreeConfig(max_depth=3, task="regression_variance"),
        loss="squared", seed=seed)


@pytest.fixture(scope="module")
def problem():
    return _binary_problem()


@pytest.fixture(scope="module")
def fits(problem):
    table, yb = problem
    return (_mk_squared(seed=1).fit(table, yb, device=CPU),
            _mk_squared(seed=2).fit(table, yb, device=CPU))


@pytest.fixture
def registry(problem, fits):
    table, _ = problem
    reg = ModelRegistry(capacity=2, device=CPU)
    reg.add("a", fits[0])
    reg.add("b", fits[1])
    return reg, np.asarray(table.bins)[:4]


def _expect(reg, rows, mid=0):
    return reg.predict(np.full(len(rows), mid, np.int32),
                       reg.pad_bins(rows)).numpy()


# ------------------------------------------------------ serving degradation


def test_submit_backpressure_bounded_queue(registry):
    reg, rows = registry
    server = ForestServer(reg, BatchPolicy(),
                          admission=AdmissionPolicy(max_pending_rows=8))
    server.submit(0, rows, now=0.0)
    server.submit(0, rows, now=0.0)
    with pytest.raises(QueueFullError, match="flush"):
        server.submit(0, rows, now=0.0)
    assert server.stats["rejected_full"] == 1
    server.flush(now=0.0)
    req = server.submit(0, rows, now=0.0)
    np.testing.assert_array_equal(req.result(), _expect(reg, rows))


def test_deadline_shed_with_injected_clock(registry):
    reg, rows = registry
    clock = SkewClock()
    server = ForestServer(reg, BatchPolicy(),
                          admission=AdmissionPolicy(deadline=1.0))
    stale = server.submit(0, rows, now=clock())
    clock.advance(10.0)
    fresh = server.submit(0, rows, now=clock())
    server.flush(now=clock())
    with pytest.raises(DeadlineExceededError):
        stale.result()
    assert stale.exception() is not None and fresh.exception() is None
    assert server.stats["shed"] == 1
    np.testing.assert_array_equal(fresh.result(), _expect(reg, rows))
    with pytest.raises(ValueError, match="backwards"):
        clock.advance(-1.0)


def test_retry_backoff_then_success(registry):
    reg, rows = registry
    inj, sleeps = TransientFaults(2), []
    server = ForestServer(
        reg, BatchPolicy(),
        admission=AdmissionPolicy(max_attempts=3, backoff_base=0.05),
        fault_injector=inj, sleep=sleeps.append)
    out = server.predict(0, rows)
    np.testing.assert_array_equal(out, _expect(reg, rows))
    assert sleeps == [0.05, 0.1]
    assert inj.calls == 3 and server.stats["retries"] == 2


def test_retries_exhausted_is_typed(registry):
    reg, rows = registry
    server = ForestServer(
        reg, BatchPolicy(),
        admission=AdmissionPolicy(max_attempts=2, backoff_base=0.0),
        fault_injector=TransientFaults(100), sleep=lambda s: None)
    req = server.submit(0, rows)
    server.flush()
    with pytest.raises(RetriesExhaustedError) as ei:
        req.result()
    assert ei.value.attempts == 2
    assert req.done()


@pytest.mark.parametrize("kw", [dict(max_pending_rows=0),
                                dict(max_attempts=0), dict(deadline=0.0)])
def test_admission_policy_rejects_bad_bounds(kw):
    with pytest.raises(ValueError):
        AdmissionPolicy(**kw)


def test_breaker_quarantine_isolation_and_half_open(problem, fits):
    table, yb = problem
    rows = np.asarray(table.bins)[:4]
    reg = ModelRegistry(capacity=2, device=CPU)
    reg.add("a", fits[0])
    reg.add("b", fits[1])
    expect = {m: _expect(reg, rows, m) for m in (0, 1)}
    tables = reg.tables
    clock = SkewClock()
    server = ForestServer(
        reg, BatchPolicy(),
        breaker=CircuitBreaker(threshold=1, cooldown=5.0))
    poison_tenant(reg, 0)
    assert reg.tables is tables and np.isnan(
        reg.tables["label"][0].numpy()).all()    # in place, on the device

    req = server.submit(0, rows, now=clock())
    server.flush(now=clock())
    with pytest.raises(NonFiniteOutputError):
        req.result()
    assert server.breaker.state(0) == "open"
    with pytest.raises(TenantUnavailableError):
        server.submit(0, rows, now=clock())
    req = server.submit(1, rows, now=clock())
    server.flush(now=clock())
    np.testing.assert_array_equal(req.result(), expect[1])

    reg.remove("a")
    reg.add("a", _mk_squared(seed=1).fit(table, yb, device=CPU))
    clock.advance(6.0)
    req = server.submit(0, rows, now=clock())
    assert server.breaker.state(0) == "half-open"
    with pytest.raises(TenantUnavailableError):
        server.submit(0, rows, now=clock())
    server.flush(now=clock())
    np.testing.assert_array_equal(req.result(), expect[0])
    assert server.breaker.state(0) == "closed"
    assert server.compile_count == 1


def test_breaker_disabled_restores_legacy_silent_nan(problem, fits):
    table, _ = problem
    rows = np.asarray(table.bins)[:4]
    reg = ModelRegistry(capacity=2, device=CPU)
    reg.add("a", fits[0])
    server = ForestServer(reg, BatchPolicy(),
                          breaker=CircuitBreaker(enabled=False))
    poison_tenant(reg, 0)
    out = server.predict(0, rows)
    assert not np.isfinite(out).all()


def test_breaker_threshold_counts_consecutive_failures():
    br = CircuitBreaker(threshold=2, cooldown=1.0)
    br.record_failure(7, now=0.0)
    assert br.allow(7, 0.0) and br.state(7) == "closed"
    br.record_failure(7, now=0.5)
    assert not br.allow(7, 0.6) and br.state(7) == "open"
    assert br.allow(7, 1.5) and not br.allow(7, 1.5)   # one probe
    br.record_success(7)
    assert br.state(7) == "closed"
    with pytest.raises(ValueError):
        CircuitBreaker(threshold=0)


# --------------------------------------------------- fit input validation


def test_fit_rejects_poisoned_float_column(problem):
    table, yb = problem
    bins = np.asarray(table.bins, dtype=np.float32).copy()
    bins[7, 2] = np.nan
    bad = dataclasses.replace(table, bins=bins)
    with pytest.raises(ValueError, match=r"column 2.*row 7"):
        _mk_gbt().fit(bad, yb, device=CPU)
    with pytest.raises(ValueError, match="column 2"):
        RandomForest(n_trees=2).fit(bad, (yb > 0).astype(np.int32),
                                    device=CPU)


@pytest.mark.parametrize("value", [np.nan, np.inf])
def test_fit_rejects_nonfinite_labels_and_weights(problem, value):
    table, yb = problem
    bad_y = yb.copy()
    bad_y[[5, 6]] = value
    with pytest.raises(ValueError, match="non-finite labels"):
        _mk_gbt().fit(table, bad_y, device=CPU)
    if value is np.nan:
        np.testing.assert_array_equal(poison_labels(yb, [5, 6]), bad_y)
    sw = np.ones(len(yb), np.float32)
    sw[3] = value
    with pytest.raises(ValueError, match="sample_weight"):
        _mk_gbt().fit(table, yb, sample_weight=sw, device=CPU)
    with pytest.raises(ValueError, match="sample_weight"):
        RandomForest(n_trees=2).fit(table, (yb > 0).astype(np.int32),
                                    sample_weight=sw, device=CPU)
    sw[3] = -1.0
    with pytest.raises(ValueError, match="sample_weight"):
        _mk_gbt().fit(table, yb, sample_weight=sw, device=CPU)


# ---------------------------------------------- injected training faults


@pytest.mark.parametrize("mode", ["truncate", "bitflip", "manifest"])
def test_corrupt_checkpoint_rejected(problem, tmp_path, mode):
    table, yb = problem
    ck = str(tmp_path / "ck")
    with pytest.raises(PreemptedError):
        _mk_gbt().fit(table, yb, device=CPU, round_callback=chain(
            RoundCheckpointer(ck), preempt_at_round(2)))
    corrupt_checkpoint(ck, mode=mode, seed=1)
    with pytest.raises(CheckpointCorruptError):
        restore_round_state(ck)
    assert restore_round_state(ck, step=1).round == 1


# ----------------------------------------------------- against the reference


@pytest.mark.parametrize("seed", range(5))
def test_make_plan_equals_reference(seed):
    for n_rounds, m, n_tenants in ((6, 600, 2), (20, 444619, 4)):
        got = make_plan(seed, n_rounds=n_rounds, m=m, n_tenants=n_tenants)
        want = jmake_plan(seed, n_rounds=n_rounds, m=m, n_tenants=n_tenants)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def chaos_reports():
    return run_chaos(0, device=CPU), jrun_chaos(0)


def test_run_chaos_equals_reference(chaos_reports):
    got, want = chaos_reports
    assert [(o["fault"], o["outcome"]) for o in got["outcomes"]] == \
        [(o["fault"], o["outcome"]) for o in want["outcomes"]]
    for key in ("seed", "breaker_enabled", "digest_check", "plan",
                "faults_injected", "recovered_exact", "degraded_graceful",
                "unhandled", "resume_parity_max_abs", "shed", "served",
                "retries"):
        assert got[key] == want[key], key
    assert got["faults_injected"] == 14 and got["unhandled"] == 0
    assert got["resume_parity_max_abs"] == 0.0


@pytest.mark.parametrize("flag,fault", [("breaker_enabled", "poison_tenant"),
                                        ("digest_check", "digest_mismatch")])
def test_chaos_flips_unhandled_when_guards_disabled(flag, fault):
    """Disabling either guard surfaces at least one silently-wrong answer."""
    rep = run_chaos(0, device=CPU, **{flag: False})
    assert rep["unhandled"] > 0
    assert any(o["fault"] == fault and o["outcome"] == "unhandled"
               for o in rep["outcomes"])


# ------------------------------------------------------------ kdd99 download


class _Resp:
    def __init__(self, data):
        self._data = data

    def read(self):
        return self._data

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _kdd_lines(n=5):
    rng = np.random.default_rng(3)
    labels = list(kdd99.ATTACK_SUPERCLASS)
    lines = []
    for i in range(n):
        f = [str(round(float(v), 3)) for v in rng.normal(size=41)]
        f[1] = ("tcp", "udp", "icmp")[i % 3]
        f[2], f[3] = "http", "SF"
        lines.append(",".join(f + [labels[i % len(labels)] + "."]))
    return "\n".join(lines) + "\n"


def test_download_retries_with_backoff_then_raises(tmp_path, monkeypatch):
    calls, sleeps = [], []

    def urlopen(url, timeout=None):
        calls.append(url)
        raise urllib.error.URLError("connection refused")

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    out = kdd99._download(tmp_path / "x.gz", attempts=3,
                          backoff_base=0.5, sleep=sleeps.append)
    assert out is None
    assert len(calls) == 3 * len(kdd99._URLS)
    assert kdd99._URLS == jkdd99._URLS
    assert sleeps == [0.5, 1.0]
    assert len(kdd99._download.last_errors) == len(calls)
    assert not (tmp_path / "x.gz").exists()


def test_download_rejects_corrupt_payload_before_caching(tmp_path,
                                                         monkeypatch):
    good = "0,tcp,http,SF," + ",".join(["0"] * 37) + ",normal.\n"
    payloads = iter([
        b"<html>404 not found</html>",
        gzip.compress(b"<html>mirror error page</html>"),
        gzip.compress(good.encode() * 5),
    ])
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda url, timeout=None: _Resp(next(payloads)))
    dest = tmp_path / "kdd.gz"
    raw = kdd99._download(dest, attempts=2, sleep=lambda s: None)
    assert raw is not None and raw.startswith(b"0,tcp,http,SF")
    assert dest.exists()
    num, cats, y = kdd99._parse_raw(raw)
    assert num.shape == (5, kdd99.N_FEATURES - len(kdd99.CAT_COLS))
    assert list(y) == [0] * 5
    errs = kdd99._download.last_errors
    assert len(errs) == 2 and "BadGzipFile" in errs[0]


def test_explicit_allow_download_failure_raises(tmp_path, monkeypatch):
    def urlopen(url, timeout=None):
        raise urllib.error.URLError("no route to host")

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    monkeypatch.setattr(kdd99.time, "sleep", lambda s: None)
    monkeypatch.setenv("REPRO_KDD99_CACHE", str(tmp_path / "cache"))
    with pytest.raises(kdd99.DownloadError, match="allow_download=True"):
        kdd99.load_kdd99(m=100, allow_download=True)
    cols, y, info = kdd99.load_kdd99(m=100, allow_download=False)
    assert info["source"] == "synthetic" and len(y) == 100
    monkeypatch.setenv("REPRO_KDD99_OFFLINE", "1")
    cols, y, info = kdd99.load_kdd99(m=100)        # env: never the network
    assert info["source"] == "synthetic"


def test_parse_raw_equals_reference():
    raw = _kdd_lines(40).encode()
    got, want = kdd99._parse_raw(raw), jkdd99._parse_raw(raw)
    np.testing.assert_array_equal(got[0], want[0])
    for j in kdd99.CAT_COLS:
        assert list(got[1][j]) == list(want[1][j])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].dtype == want[0].dtype and got[2].dtype == want[2].dtype


def test_load_kdd99_reads_the_cache_like_the_reference(tmp_path,
                                                       monkeypatch):
    """The raw ``.gz`` in the cache is parsed and re-cached as npz; both
    packages then load the same columns, labels and info from it."""
    monkeypatch.setenv("REPRO_KDD99_CACHE", str(tmp_path))
    (tmp_path / "kddcup.data_10_percent.gz").write_bytes(
        gzip.compress(_kdd_lines(60).encode()))
    cols, y, info = kdd99.load_kdd99(m=50, seed=1, allow_download=False)
    assert (tmp_path / "kdd99_5class.npz").exists()
    jcols, jy, jinfo = jkdd99.load_kdd99(m=50, seed=1, allow_download=False)
    assert info == jinfo and info["source"] == "real"
    np.testing.assert_array_equal(y, jy)
    for j, (a, b) in enumerate(zip(cols, jcols)):
        if j in kdd99.CAT_COLS:
            assert list(a) == list(b)
        else:
            np.testing.assert_array_equal(a, b)
