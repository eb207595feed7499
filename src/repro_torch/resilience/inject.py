"""Deterministic fault injection: every failure the stack must survive
(counterpart of ``repro.resilience.inject``; the same seeded plans).

One module owns the fault vocabulary so tests, the chaos harness and the
chaos gate all inject the SAME faults the same way.  Faults are seeded
and reproducible — a chaos run is a deterministic program whose expected
outcome ("recovered exactly" or "degraded gracefully") is assertable,
never a flaky coin flip:

  * ``kill_at_round`` / ``preempt_at_round`` — preemption mid-ensemble:
    the former SIGKILLs the process (subprocess tests), the latter raises
    :class:`PreemptedError` in-process (the harness's fast analogue);
  * ``poison_labels`` — NaN-in-gradients: non-finite labels that must be
    rejected at fit entry, never trained into NaN trees;
  * ``corrupt_checkpoint`` — truncates or bit-flips a round checkpoint
    shard (or garbles its manifest): restore must raise
    ``CheckpointCorruptError``, never load garbage;
  * ``SkewClock`` — a slow-tick injectable clock: requests age past
    deadlines without any real waiting;
  * ``poison_tenant`` — writes NaN into one tenant's resident label
    table (host mirror and device tensor, in place): that tenant must be
    quarantined while others serve on;
  * ``TransientFaults`` — a fault injector for the server's executor
    path: fails the first ``n`` calls with ``TransientServeError``.
"""
from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np

from repro_torch.serve.degrade import TransientServeError

__all__ = ["FaultPlan", "make_plan", "PreemptedError", "kill_at_round",
           "preempt_at_round", "chain", "poison_labels",
           "corrupt_checkpoint", "SkewClock", "poison_tenant",
           "TransientFaults"]


class PreemptedError(RuntimeError):
    """In-process stand-in for a worker preemption (the subprocess tests
    use a real SIGKILL; the harness catches this instead)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One seeded chaos scenario: which round dies, which rows are
    poisoned, how a checkpoint is corrupted, how far the clock skews,
    which tenant's tables get NaNs, and how many transient executor
    faults to inject.  Derived deterministically by :func:`make_plan` —
    the chaos gate's whole run is a pure function of ``seed``."""
    seed: int
    kill_round: int
    poison_rows: tuple
    corrupt_mode: str
    skew_seconds: float
    poison_tenant_id: int
    transient_faults: int


def make_plan(seed: int, *, n_rounds: int, m: int,
              n_tenants: int) -> FaultPlan:
    """Derive a :class:`FaultPlan` from ``seed`` for a fit of
    ``n_rounds`` rounds over ``m`` rows serving ``n_tenants`` tenants.
    The kill lands strictly mid-ensemble (never round 0 or the last
    round) so resume has both a prefix to restore and work left to do."""
    rng = np.random.default_rng(seed)
    kill = int(rng.integers(1, max(2, n_rounds - 1)))
    rows = tuple(int(r) for r in
                 rng.choice(m, size=min(3, m), replace=False))
    mode = ("truncate", "bitflip", "manifest")[int(rng.integers(0, 3))]
    return FaultPlan(
        seed=seed, kill_round=kill, poison_rows=rows, corrupt_mode=mode,
        skew_seconds=float(rng.uniform(5.0, 50.0)),
        poison_tenant_id=int(rng.integers(0, n_tenants)),
        transient_faults=int(rng.integers(1, 3)))


def chain(*callbacks):
    """Compose round callbacks left-to-right (checkpoint first, THEN
    kill — so the checkpoint of the fatal round is already durable)."""
    def cb(state):
        for c in callbacks:
            c(state)
    return cb


def kill_at_round(round_: int, signum: int = signal.SIGKILL):
    """Round callback that kills the process the instant ``round_``
    completes — no cleanup, no atexit, exactly like a preemption."""
    def cb(state):
        if state.round == round_:
            os.kill(os.getpid(), signum)
    return cb


def preempt_at_round(round_: int):
    """Round callback raising :class:`PreemptedError` after ``round_``
    completes — the harness's in-process preemption."""
    def cb(state):
        if state.round == round_:
            raise PreemptedError(f"preempted after round {round_}")
    return cb


def poison_labels(y, rows) -> np.ndarray:
    """A copy of ``y`` (as float) with NaN at ``rows`` — the
    NaN-in-gradients fault ``fit`` must reject by name."""
    out = np.asarray(y, dtype=np.float32).copy()
    out[list(rows)] = np.nan
    return out


def corrupt_checkpoint(directory: str, step: int | None = None, *,
                       mode: str = "bitflip", seed: int = 0) -> str:
    """Damage a round checkpoint at rest.  ``mode``: "truncate" cuts the
    npz shard in half (a partial write that dodged the atomic rename),
    "bitflip" flips one seeded byte inside it (silent media corruption —
    npz members are STORED, so only the sha256 manifest catches this),
    "manifest" garbles the JSON.  Returns the damaged step directory."""
    from repro_torch.checkpoint.checkpoint import latest_step
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    if mode == "manifest":
        path = os.path.join(d, "manifest.json")
        with open(path, "w") as f:
            f.write('{"step": 3, "keys": {   TRUNCATED MID-WRITE')
        return d
    shards = sorted(fn for fn in os.listdir(d)
                    if fn.startswith("shard_") and fn.endswith(".npz"))
    path = os.path.join(d, shards[0])
    blob = bytearray(open(path, "rb").read())
    if mode == "truncate":
        blob = blob[:len(blob) // 2]
    elif mode == "bitflip":
        # flip a byte in the middle of the member data, clear of the zip
        # directory structures at both ends
        pos = int(np.random.default_rng(seed).integers(
            len(blob) // 4, len(blob) // 2))
        blob[pos] ^= 0xFF
    else:
        raise ValueError(f"unknown corrupt mode {mode!r}")
    with open(path, "wb") as f:
        f.write(bytes(blob))
    return d


class SkewClock:
    """An injectable monotonic clock whose ticks the scenario controls:
    ``clock()`` reads it, ``advance(dt)`` jumps it forward (a stalled
    executor, a GC pause, a slow tick).  Deterministic deadline pressure
    with zero real waiting."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("a monotonic clock never goes backwards")
        self.t += float(dt)
        return self.t


def poison_tenant(registry, model_id: int) -> None:
    """Write NaN into one tenant's resident label table (reaching into
    the registry's buffers ON PURPOSE -- this simulates corruption of the
    serving state itself, below every API-level guard): the host mirror,
    then the device tensor in place, so serve graphs already captured
    against the tables read the poison on their next replay."""
    if registry._np is None:
        raise ValueError("empty registry")
    registry._np["label"][model_id, :, :] = np.nan
    registry._push_slot(model_id)


class TransientFaults:
    """Executor fault injector: the first ``n`` calls raise
    ``TransientServeError``, later calls pass.  Plug into
    ``ForestServer(fault_injector=...)``; ``calls`` counts attempts."""

    def __init__(self, n: int):
        self.n = n
        self.calls = 0

    def __call__(self, site: str, attempt: int) -> None:
        self.calls += 1
        if self.calls <= self.n:
            raise TransientServeError(
                f"injected transient fault {self.calls}/{self.n} "
                f"at {site!r} (attempt {attempt})")
