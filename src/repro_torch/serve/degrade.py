"""Graceful degradation primitives for the forest server (counterpart of
``repro.serve.degrade``; pure Python, kept as the port's own copy).

A production serve layer fails in bounded, EXPLICIT ways or not at all:

  * a request the server cannot queue is REJECTED at submit
    (:class:`QueueFullError` — retryable backpressure, never an unbounded
    queue);
  * a request that outlives its deadline is SHED at flush with
    :class:`DeadlineExceededError` (deterministic under the injectable
    ``now=`` clock), never served late as if nothing happened;
  * a transient executor failure is retried with exponential backoff;
    exhaustion surfaces as :class:`RetriesExhaustedError` carrying the
    last cause;
  * a tenant whose model produces non-finite outputs (a poisoned table, a
    corrupted registry write) trips a per-tenant :class:`CircuitBreaker`:
    its requests get 503-style :class:`TenantUnavailableError` rejections
    while every other tenant keeps being served — one bad tenant must
    never take the registry down.

Every error type here is an explicit, catchable contract: the chaos
scenario (``resilience.harness.run_chaos``) injects each fault and
asserts the outcome is one of these errors or a bit-exact recovery --
never a hang, never a silently wrong answer.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ServeError", "QueueFullError", "DeadlineExceededError",
           "TenantUnavailableError", "NonFiniteOutputError",
           "TransientServeError", "RetriesExhaustedError",
           "AdmissionPolicy", "CircuitBreaker"]


class ServeError(RuntimeError):
    """Base class of every explicit serving failure."""


class QueueFullError(ServeError):
    """Backpressure: the admission queue is at ``max_pending_rows``.
    Retryable — flush (or wait for a tick) and resubmit."""


class DeadlineExceededError(ServeError):
    """The request aged past its deadline while queued and was shed
    un-executed.  The caller sees this instead of a late answer."""


class TenantUnavailableError(ServeError):
    """503 for one tenant: its circuit breaker is open (recent non-finite
    outputs).  Other tenants are unaffected; retry after the cooldown."""

    def __init__(self, model_id: int, msg: str):
        super().__init__(msg)
        self.model_id = model_id


class NonFiniteOutputError(ServeError):
    """This request's outputs contained NaN/inf (detected by the on-device
    finiteness lane of the routed walk).  The raw values are withheld —
    a wrong answer must never look like an answer."""

    def __init__(self, model_id: int, msg: str):
        super().__init__(msg)
        self.model_id = model_id


class TransientServeError(ServeError):
    """A retryable executor failure (fault injection uses this type
    directly; real transient runtime failures surface as RuntimeError and
    are retried the same way)."""


class RetriesExhaustedError(ServeError):
    """Every retry attempt failed; ``__cause__`` carries the last error."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(
            f"serve executor failed after {attempts} attempts: {last}")
        self.attempts = attempts
        self.__cause__ = last


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Bounds on what the server will accept and how hard it tries.

    ``max_pending_rows`` caps the queue (submit past it raises
    :class:`QueueFullError` — the explicit, retryable backpressure signal
    that replaces the old unbounded queue).  ``deadline`` (seconds from
    submit, ``None`` = never) is the default per-request deadline;
    ``submit(deadline=...)`` overrides it.  ``max_attempts`` /
    ``backoff_base`` drive retry-with-exponential-backoff around the
    executor (sleep ``backoff_base * 2**i`` after attempt i)."""
    max_pending_rows: int = 4096
    deadline: float | None = None
    max_attempts: int = 3
    backoff_base: float = 0.01

    def __post_init__(self):
        if self.max_pending_rows < 1:
            raise ValueError("max_pending_rows must be >= 1, got "
                             f"{self.max_pending_rows}")
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(f"deadline must be positive, got "
                             f"{self.deadline}")


class CircuitBreaker:
    """Per-key (model-id) breaker: CLOSED -> OPEN -> HALF_OPEN -> ...

    ``threshold`` consecutive failures open the circuit; while open,
    ``allow`` is False (the server serves 503-style rejections for that
    key only).  After ``cooldown`` seconds (on the caller's clock — the
    server passes its injectable ``now``) ONE probe request is admitted
    (half-open); its success closes the circuit, its failure re-opens it
    for a fresh cooldown.  ``enabled=False`` turns the breaker into a
    pass-through that also disables the non-finite output quarantine —
    that restores the legacy silent-NaN behaviour, and exists so the
    chaos gate can PROVE the breaker matters (disabling it flips the gate
    nonzero)."""

    def __init__(self, *, threshold: int = 1, cooldown: float = 1.0,
                 enabled: bool = True):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown = cooldown
        self.enabled = enabled
        # key -> {fails, opened (time or None), probing}
        self._state: dict = {}

    def _entry(self, key):
        return self._state.setdefault(
            key, dict(fails=0, opened=None, probing=False))

    def state(self, key) -> str:
        """"closed" / "open" / "half-open" at the last observed clock."""
        st = self._state.get(key)
        if st is None or st["opened"] is None:
            return "closed"
        return "half-open" if st["probing"] else "open"

    def allow(self, key, now: float) -> bool:
        """May a request for ``key`` be admitted at time ``now``?  While
        open: False until ``cooldown`` has elapsed, then one half-open
        probe slips through (subsequent calls stay rejected until the
        probe's success/failure is recorded)."""
        if not self.enabled:
            return True
        st = self._state.get(key)
        if st is None or st["opened"] is None:
            return True
        if st["probing"]:
            return False                 # one probe in flight already
        if now - st["opened"] >= self.cooldown:
            st["probing"] = True         # admit exactly one probe
            return True
        return False

    def record_success(self, key) -> None:
        st = self._state.get(key)
        if st is not None:
            st.update(fails=0, opened=None, probing=False)

    def record_failure(self, key, now: float) -> None:
        st = self._entry(key)
        st["fails"] += 1
        st["probing"] = False
        if st["fails"] >= self.threshold:
            st["opened"] = now
