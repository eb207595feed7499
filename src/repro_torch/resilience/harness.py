"""The deterministic chaos scenario: every injected fault, one verdict
(counterpart of ``repro.resilience.harness``).

``run_chaos`` executes one seeded ``inject.FaultPlan`` end to end against real components — real fits, real round
checkpoints, a real registry and server — and classifies every injected
fault as exactly one of:

  * ``recovered_exact`` — the system came back BIT-IDENTICAL to the
    un-faulted execution (resumed fits, repaired tenants, retried
    batches, served survivors under deadline pressure);
  * ``degraded_graceful`` — the fault could not be transparently
    absorbed, and the system failed EXPLICITLY: a typed error naming the
    problem (rejected NaN labels, a loud corrupt-checkpoint error, a
    shed deadline, a 503 quarantine, exhausted retries) — never a hang,
    never a silently wrong answer;
  * ``unhandled`` — anything else.  One unhandled fault fails the
    scenario.

``breaker_enabled=False`` and ``digest_check=False`` deliberately
re-open the two silent-wrong-answer holes the guards close (served NaNs;
resuming under a mismatched config) so a run can PROVE its guards
matter: either flag flips at least one fault to ``unhandled`` (tested).
The whole run is a pure function of ``seed`` — tiny shapes, injected
clocks and sleeps, no real waiting.

The port runs the reference's scenario unchanged (the same 600 x 5 data,
the same 6-round depth-3 GOSS estimator, the same 14 faults in the same
order) on ``device`` (``None`` means CUDA): the fits grow their trees
through the histogram and split-scan kernels (``hist_backend`` and
``select_backend`` "kernel", which take their plain versions on the CPU),
the checkpoints are the port's, and the servers replay CUDA graphs.  The
fits draw GOSS rows from a torch generator, so their trees are not the
reference's; every verdict compares the port with itself.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.checkpoint.round_ckpt import (CheckpointCorruptError,
                                               CheckpointMismatchError,
                                               RoundCheckpointer,
                                               restore_round_state)
from repro_torch.core.binning import fit_bins
from repro_torch.core.forest import GossConfig, GradientBoostedTrees
from repro_torch.core.tree import TreeConfig
from repro_torch.resilience import inject
from repro_torch.serve.batching import BatchPolicy, ForestServer
from repro_torch.serve.degrade import (AdmissionPolicy, CircuitBreaker,
                                       DeadlineExceededError,
                                       NonFiniteOutputError, QueueFullError,
                                       RetriesExhaustedError,
                                       TenantUnavailableError)
from repro_torch.serve.registry import ModelRegistry

__all__ = ["run_chaos"]

_M, _K, _ROUNDS, _DEPTH = 600, 5, 6, 3


def _dataset(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(_M, _K))
    y = (x[:, 0] + 0.5 * x[:, 1] - 0.25 * x[:, 2]
         + 0.3 * rng.normal(size=_M)).astype(np.float32)
    table = fit_bins([x[:, j] for j in range(_K)])
    return table, y


def _estimator(seed: int) -> GradientBoostedTrees:
    # squared loss => identity link: served outputs equal raw scores,
    # so serve parity checks are direct bit comparisons
    return GradientBoostedTrees(
        n_trees=_ROUNDS, learning_rate=0.3,
        config=TreeConfig(max_depth=_DEPTH, task="regression_variance",
                          hist_backend="kernel", select_backend="kernel"),
        goss=GossConfig(0.3, 0.2), loss="squared", seed=seed)


class _Verdicts:
    def __init__(self):
        self.faults: list[tuple[str, str, str]] = []

    def add(self, name: str, outcome: str, detail: str = ""):
        assert outcome in ("recovered_exact", "degraded_graceful",
                           "unhandled")
        self.faults.append((name, outcome, detail))


def run_chaos(seed: int = 0, *, breaker_enabled: bool = True,
              digest_check: bool = True, work_dir: str | None = None,
              device=None) -> dict:
    """Run the full chaos scenario on ``device`` (``None`` means CUDA);
    returns the reference's report dict (see module docstring for the
    outcome taxonomy)."""
    dev = resolve_device(device)
    plan = inject.make_plan(seed, n_rounds=_ROUNDS, m=_M, n_tenants=2)
    table, y = _dataset(seed)
    v = _Verdicts()
    tmp = None
    if work_dir is None:
        tmp = tempfile.TemporaryDirectory()
        work_dir = tmp.name
    ckdir = os.path.join(work_dir, "round_ckpt")
    try:
        # -- training faults ---------------------------------------------
        ref = _estimator(seed).fit(table, y, device=dev)
        p_ref = ref.predict_raw(table.bins)
        resume_parity = _fault_preemption(v, dev, plan, table, y, p_ref,
                                          ckdir)
        _fault_digest_mismatch(v, dev, table, y, ckdir, seed,
                               digest_check=digest_check)
        _fault_corrupt_checkpoint(v, dev, plan, table, y, p_ref, ckdir,
                                  seed)
        _fault_nan_labels(v, dev, plan, table, y)

        # -- serving faults ----------------------------------------------
        models = {"tenant-a": ref, "tenant-b": _estimator(seed + 1000)
                  .fit(table, y, device=dev)}
        shed, served = _serving_faults(v, dev, plan, table, models,
                                       breaker_enabled=breaker_enabled)
        retries = _fault_transients(v, dev, plan, table, models)
        _fault_backpressure(v, dev, table, models)
    finally:
        if tmp is not None:
            tmp.cleanup()

    counts = dict(recovered_exact=0, degraded_graceful=0, unhandled=0)
    for _, outcome, _ in v.faults:
        counts[outcome] += 1
    return dict(
        seed=seed, breaker_enabled=breaker_enabled,
        digest_check=digest_check,
        plan=dict(kill_round=plan.kill_round,
                  corrupt_mode=plan.corrupt_mode,
                  poison_tenant_id=plan.poison_tenant_id,
                  transient_faults=plan.transient_faults),
        faults_injected=len(v.faults),
        **counts,
        resume_parity_max_abs=float(resume_parity),
        shed=int(shed), served=int(served), retries=int(retries),
        outcomes=[dict(fault=n, outcome=o, detail=d)
                  for n, o, d in v.faults],
    )


# -- training-side faults ---------------------------------------------------

def _fault_preemption(v, dev, plan, table, y, p_ref, ckdir) -> float:
    """kill-at-round-r (in-process): checkpoint every round, preempt
    after round ``plan.kill_round``, resume, demand bit-identity."""
    est = _estimator(plan.seed)
    cb = inject.chain(RoundCheckpointer(ckdir),
                      inject.preempt_at_round(plan.kill_round))
    try:
        est.fit(table, y, round_callback=cb, device=dev)
        v.add("preempt_resume", "unhandled",
              f"preemption at round {plan.kill_round} never fired")
        return float("nan")
    except inject.PreemptedError:
        pass
    resumed = _estimator(plan.seed).fit(table, y, resume_from=ckdir,
                                        device=dev)
    parity = float(np.max(np.abs(p_ref - resumed.predict_raw(table.bins))))
    if parity == 0.0:
        v.add("preempt_resume", "recovered_exact",
              f"resumed at round {plan.kill_round}, bit-identical")
    else:
        v.add("preempt_resume", "unhandled",
              f"resume parity {parity:g} != 0")
    return parity


def _fault_digest_mismatch(v, dev, table, y, ckdir, seed, *, digest_check):
    """Resume under a DIFFERENT config (seed).  With the digest check on
    this must be refused loudly; with it off (``digest_check=False``)
    the fit silently produces an ensemble no uninterrupted fit
    could — detected here as an unhandled silent wrong answer."""
    other = _estimator(seed + 1)
    if digest_check:
        try:
            other.fit(table, y, resume_from=ckdir, device=dev)
            v.add("digest_mismatch", "unhandled",
                  "mismatched-config resume was silently accepted")
        except CheckpointMismatchError:
            v.add("digest_mismatch", "degraded_graceful",
                  "mismatched-config resume rejected loudly")
        return
    ck = restore_round_state(ckdir)._replace(digest=None)
    other.fit(table, y, resume_from=ck, device=dev)
    p_mixed = other.predict_raw(table.bins)
    p_honest = (_estimator(seed + 1).fit(table, y, device=dev)
                .predict_raw(table.bins))
    if np.array_equal(p_mixed, p_honest):
        v.add("digest_mismatch", "recovered_exact",
              "foreign prefix happened to be identical")
    else:
        v.add("digest_mismatch", "unhandled",
              "digest check disabled: mismatched resume silently "
              "produced a frankenstein ensemble "
              f"(max dev {float(np.max(np.abs(p_mixed - p_honest))):g})")


def _fault_corrupt_checkpoint(v, dev, plan, table, y, p_ref, ckdir, seed):
    """Corrupt the newest checkpoint at rest: restore must fail LOUDLY,
    then recovery proceeds from the previous intact round (or a fresh
    fit) and must still be bit-identical."""
    inject.corrupt_checkpoint(ckdir, mode=plan.corrupt_mode, seed=seed)
    try:
        restore_round_state(ckdir)
        v.add("corrupt_checkpoint", "unhandled",
              f"{plan.corrupt_mode}-corrupted checkpoint restored "
              "without error")
        return
    except CheckpointCorruptError:
        v.add("corrupt_checkpoint", "degraded_graceful",
              f"{plan.corrupt_mode} corruption detected loudly")
    if plan.kill_round >= 2:
        ck = restore_round_state(ckdir, step=plan.kill_round - 1)
        resumed = _estimator(plan.seed).fit(table, y, resume_from=ck,
                                            device=dev)
        detail = f"resumed from intact round {plan.kill_round - 1}"
    else:
        resumed = _estimator(plan.seed).fit(table, y, device=dev)
        detail = "no intact prefix; refit from scratch"
    parity = float(np.max(np.abs(p_ref - resumed.predict_raw(table.bins))))
    v.add("corrupt_recover",
          "recovered_exact" if parity == 0.0 else "unhandled",
          detail if parity == 0.0 else f"recovery parity {parity:g} != 0")


def _fault_nan_labels(v, dev, plan, table, y):
    """NaN-in-gradients: poisoned labels must be rejected BY NAME at fit
    entry, never trained into NaN trees."""
    bad_y = inject.poison_labels(y, plan.poison_rows)
    try:
        _estimator(plan.seed).fit(table, bad_y, device=dev)
        v.add("nan_labels", "unhandled",
              "fit silently trained on NaN labels")
    except ValueError as e:
        v.add("nan_labels", "degraded_graceful",
              f"rejected at fit entry: {str(e)[:60]}")


# -- serving-side faults ----------------------------------------------------

def _requests(table, rng, n=4):
    idx = rng.choice(table.bins.shape[0], size=n, replace=False)
    return np.asarray(table.bins)[idx]


def _serving_faults(v, dev, plan, table, models, *, breaker_enabled):
    """Poisoned tenant table + quarantine + repair, then deadline skew.
    Returns (shed, served) counts for the report."""
    reg = ModelRegistry(capacity=2, device=dev)
    mids = {name: reg.add(name, est) for name, est in models.items()}
    clock = inject.SkewClock()
    rng = np.random.default_rng(plan.seed + 7)
    bins_by_mid = {mid: _requests(table, rng) for mid in mids.values()}
    expected = {mid: reg.predict(
        np.full(b.shape[0], mid, np.int32), reg.pad_bins(b)).cpu().numpy()
        for mid, b in bins_by_mid.items()}

    cooldown = 2.0
    server = ForestServer(
        reg, BatchPolicy(),
        admission=AdmissionPolicy(max_attempts=2, backoff_base=0.0),
        breaker=CircuitBreaker(threshold=1, cooldown=cooldown,
                               enabled=breaker_enabled),
        sleep=lambda s: None)
    bad = plan.poison_tenant_id
    good = 1 - bad
    names = {mid: name for name, mid in mids.items()}
    inject.poison_tenant(reg, bad)

    # 1. the poisoned tenant's request must resolve to a typed error
    req = server.submit(bad, bins_by_mid[bad], now=clock())
    server.flush(now=clock())
    try:
        out = req.result()
        if np.isfinite(out).all():
            v.add("poison_tenant", "recovered_exact",
                  "outputs unexpectedly finite")
        else:
            v.add("poison_tenant", "unhandled",
                  "served NaN outputs as if they were answers "
                  "(breaker disabled restores the legacy hole)")
    except NonFiniteOutputError:
        v.add("poison_tenant", "degraded_graceful",
              "non-finite outputs withheld, breaker opened")

    # 2. while quarantined: 503 for the bad tenant, full service for the
    # good one — one bad tenant must never take the registry down
    if breaker_enabled:
        try:
            server.submit(bad, bins_by_mid[bad], now=clock())
            v.add("quarantine_503", "unhandled",
                  "open breaker admitted a request")
        except TenantUnavailableError:
            v.add("quarantine_503", "degraded_graceful",
                  "503-style rejection while the circuit is open")
    req = server.submit(good, bins_by_mid[good], now=clock())
    server.flush(now=clock())
    got = req.result()
    v.add("tenant_isolation",
          "recovered_exact" if np.array_equal(got, expected[good])
          else "unhandled",
          "unaffected tenant served bit-exact during quarantine"
          if np.array_equal(got, expected[good])
          else "healthy tenant outputs diverged")

    # 3. repair the tenant, wait out the cooldown, half-open probe closes
    if breaker_enabled:
        reg.remove(names[bad])
        reg.add(names[bad], models[names[bad]])
        clock.advance(cooldown + 1.0)
        req = server.submit(bad, bins_by_mid[bad], now=clock())
        server.flush(now=clock())
        got = req.result()
        ok = (np.array_equal(got, expected[bad])
              and server.breaker.state(bad) == "closed")
        v.add("breaker_recovery",
              "recovered_exact" if ok else "unhandled",
              "repaired tenant re-admitted via half-open probe"
              if ok else "probe did not close the breaker exactly")

    # 4. slow-tick clock skew: queued requests age past their deadline
    # and are shed explicitly; fresh requests are served bit-exact
    server2 = ForestServer(
        reg, BatchPolicy(),
        admission=AdmissionPolicy(deadline=1.0),
        breaker=CircuitBreaker(enabled=breaker_enabled),
        sleep=lambda s: None)
    stale = server2.submit(good, bins_by_mid[good], now=clock())
    clock.advance(plan.skew_seconds)          # >> deadline, zero real wait
    fresh = server2.submit(good, bins_by_mid[good], now=clock())
    server2.flush(now=clock())
    try:
        stale.result()
        v.add("deadline_skew", "unhandled",
              "expired request served as if on time")
    except DeadlineExceededError:
        v.add("deadline_skew", "degraded_graceful",
              f"request shed after {plan.skew_seconds:.1f}s skew")
    got = fresh.result()
    v.add("deadline_survivor",
          "recovered_exact" if np.array_equal(got, expected[good])
          else "unhandled",
          "fresh request under pressure served bit-exact"
          if np.array_equal(got, expected[good])
          else "survivor outputs diverged")
    if not (stale.done() and fresh.done()):
        v.add("flush_liveness", "unhandled",
              "a flushed request was left unresolved (hang)")
    return server2.stats["shed"], server2.stats["rows"]


def _fault_transients(v, dev, plan, table, models) -> int:
    """Transient executor failures: within the retry budget the batch
    succeeds bit-exact; past it, a typed exhaustion error."""
    reg = ModelRegistry(capacity=2, device=dev)
    mid = reg.add("tenant-a", models["tenant-a"])
    rng = np.random.default_rng(plan.seed + 11)
    bins = _requests(table, rng)
    expected = reg.predict(
        np.full(bins.shape[0], mid, np.int32),
        reg.pad_bins(bins)).cpu().numpy()

    inj = inject.TransientFaults(plan.transient_faults)
    sleeps: list[float] = []
    server = ForestServer(
        reg, BatchPolicy(),
        admission=AdmissionPolicy(max_attempts=plan.transient_faults + 1,
                                  backoff_base=0.01),
        fault_injector=inj, sleep=sleeps.append)
    got = server.predict(mid, bins)
    ok = (np.array_equal(got, expected)
          and len(sleeps) == plan.transient_faults
          and all(b > 0 for b in sleeps))
    v.add("transient_retry",
          "recovered_exact" if ok else "unhandled",
          f"{plan.transient_faults} transient faults absorbed by "
          f"{len(sleeps)} backoff retries" if ok
          else "retried batch not bit-exact or backoff missing")

    server2 = ForestServer(
        reg, BatchPolicy(),
        admission=AdmissionPolicy(max_attempts=2, backoff_base=0.0),
        fault_injector=inject.TransientFaults(100),
        sleep=lambda s: None)
    req = server2.submit(mid, bins)
    server2.flush()
    try:
        req.result()
        v.add("retries_exhausted", "unhandled",
              "exhausted retries produced a result")
    except RetriesExhaustedError:
        v.add("retries_exhausted", "degraded_graceful",
              "typed exhaustion error after bounded attempts")
    return server.stats["retries"] + server2.stats["retries"]


def _fault_backpressure(v, dev, table, models):
    """Queue-bound burst: the overflow request is REJECTED (retryable),
    the queue survives, and the retry after a flush is served exactly."""
    reg = ModelRegistry(capacity=2, device=dev)
    mid = reg.add("tenant-a", models["tenant-a"])
    rng = np.random.default_rng(99)
    bins = _requests(table, rng, n=4)
    expected = reg.predict(
        np.full(bins.shape[0], mid, np.int32),
        reg.pad_bins(bins)).cpu().numpy()
    server = ForestServer(reg, BatchPolicy(),
                          admission=AdmissionPolicy(max_pending_rows=8))
    server.submit(mid, bins, now=0.0)
    server.submit(mid, bins, now=0.0)
    try:
        server.submit(mid, bins, now=0.0)
        v.add("backpressure", "unhandled",
              "queue accepted rows past the admission bound")
        return
    except QueueFullError:
        pass
    server.flush(now=0.0)
    req = server.submit(mid, bins, now=0.0)   # the caller's retry
    server.flush(now=0.0)
    got = req.result()
    v.add("backpressure",
          "degraded_graceful" if np.array_equal(got, expected)
          else "unhandled",
          "burst rejected explicitly; retry after flush served exactly"
          if np.array_equal(got, expected)
          else "retry after flush diverged")
