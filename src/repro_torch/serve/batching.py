"""Request micro-batching: padding-to-bucket shapes, one CUDA graph each
(counterpart of ``repro.serve.batching``).

The routed walk is a few hundred small gathers and elementwise ops, so on
the card launching them one by one costs more than running them.  This
server pads every batch to one of a small static set of **buckets**
(default 1/8/64/512 rows) and captures **exactly one CUDA graph per
(bucket, model-set shape)** (``serve_graph``), then replays it: the
capture set is bounded by ``len(buckets)`` per registry envelope.  The
cache is keyed on ``(bucket, registry.shape_sig)`` and ``compile_count``
counts exactly its misses; a second pass over the same traffic adds zero
captures.  When the envelope grows, the graphs of the old signature are
dropped (their memory pools freed); they never replay against the
reallocated tables.

A graph reads its request from static ``[bucket, K_cap]`` int32 bins and
``[bucket]`` gid buffers (the counterpart of the reference's donated input
buffer): ``_execute`` copies the padded chunk into them, replays, and
copies ``(out, ok)`` to the host in one transfer before anything else can
replay.  On a CPU registry the cache entry is the eager walk, so the CPU
tests exercise the same cache logic.  Nothing falls back to the eager walk
on the card: a capture or replay that fails raises.

Batching policy: requests queue in arrival order (tenants freely mixed --
routing is the registry's job) and flush when either ``max_batch`` rows
are pending or the oldest request has waited ``max_delay`` seconds
(``tick``).  A flush concatenates the queue, splits it into chunks of at
most the largest bucket -- a request larger than the largest bucket spans
several chunks -- and pads each chunk up to the smallest bucket that holds
it.  Padding rows carry model id 0 and all-zero bins; they are computed
and then **sliced away**, and because every per-row operation of the walk
is independent, the surviving rows are bit-identical to an unpadded
evaluation.

The server is single-threaded and cooperative (``submit`` / ``tick`` /
``flush``); timestamps can be injected for deterministic tests.

Degradation (``serve.degrade``, exercised by the chaos scenario):
``submit`` rejects past the admission queue bound (``QueueFullError``)
and serves 503-style ``TenantUnavailableError`` for tenants whose circuit
breaker is open; ``flush`` sheds requests that aged past their deadline
(``DeadlineExceededError``), retries transient executor failures with
exponential backoff, and quarantines any request whose outputs fail the
walk's finiteness lane (``NonFiniteOutputError`` + a breaker failure for
that tenant) -- other tenants in the same batch are served normally.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.serve.degrade import (AdmissionPolicy, CircuitBreaker,
                                       DeadlineExceededError,
                                       NonFiniteOutputError, QueueFullError,
                                       RetriesExhaustedError,
                                       TenantUnavailableError,
                                       TransientServeError)
from repro_torch.serve.registry import ModelRegistry, routed_forest_walk

__all__ = ["BatchPolicy", "ForestServer", "PendingRequest", "ServeGraph",
           "serve_graph"]


class ServeGraph:
    """One bucket's serve executable: static ``bins`` [bucket, K_cap] i32
    and ``gids`` [bucket] i32 input buffers, and on the card the captured
    ``graph`` whose outputs land in ``res`` ([2 * bucket] f32: the linked
    predictions, then the finiteness lane as 0/1).  ``graph`` is None on a
    CPU registry, where ``run`` calls the walk eagerly."""

    def __init__(self, tables, bins, gids, num_steps, graph=None, res=None):
        self.tables = tables
        self.bins = bins
        self.gids = gids
        self.num_steps = num_steps
        self.graph = graph
        self.res = res

    def run(self, gids: np.ndarray, rows: np.ndarray) -> tuple:
        """Serve one padded chunk: ``(out [bucket] f32, ok [bucket] bool)``
        as numpy."""
        self.bins.copy_(torch.from_numpy(rows))
        self.gids.copy_(torch.from_numpy(gids))
        if self.graph is None:
            res = _serve_fn(self.tables, self.bins, self.gids,
                            self.num_steps)
        else:
            self.graph.replay()
            res = self.res
        host = res.cpu().numpy()       # one device -> host transfer
        n = self.gids.shape[0]
        return host[:n], host[n:] != 0


def _serve_fn(tables, bins, gids, num_steps):
    """The walk with its two outputs in one buffer, so a chunk's result
    crosses to the host in one transfer."""
    out, ok = routed_forest_walk(tables, bins, gids, num_steps=num_steps)
    return torch.cat([out, ok.to(out.dtype)])


def serve_graph(registry: ModelRegistry, bucket: int) -> ServeGraph:
    """Build one bucket's serve executable: the counterpart of the
    reference's ``serve_lowering`` (whose compiled lowering its server
    caches).  On the card: warm the walk up on a side stream (as
    ``torch.cuda.graphs`` requires), then capture it once around the
    static input buffers and the registry's per-envelope device tables.
    A capture that fails raises; there is no eager fallback on the card.
    """
    tables = registry.tables
    dev = registry.device
    steps = registry.num_steps
    k_cap = tables["n_num"].shape[1]
    bins = torch.zeros((bucket, k_cap), dtype=torch.int32, device=dev)
    gids = torch.zeros((bucket,), dtype=torch.int32, device=dev)
    if dev.type != "cuda":
        return ServeGraph(tables, bins, gids, steps)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            _serve_fn(tables, bins, gids, steps)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        res = _serve_fn(tables, bins, gids, steps)
    return ServeGraph(tables, bins, gids, steps, graph=graph, res=res)


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Bucket + flush policy.  ``buckets`` must be ascending; the largest
    bucket is the chunk size cap.  ``max_delay`` (seconds) bounds the
    queueing latency of a lone request; ``max_batch`` rows force a flush
    regardless of age."""
    buckets: tuple = (1, 8, 64, 512)
    max_delay: float = 0.002
    max_batch: int = 512

    def __post_init__(self):
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be ascending: {self.buckets}")


class PendingRequest:
    """Handle returned by ``submit``; ``result()`` forces a flush.

    A request resolves to exactly one of: an output array, or an explicit
    ``ServeError`` (shed deadline, exhausted retries, non-finite outputs)
    which ``result()`` re-raises -- it never silently returns ``None`` or
    a wrong answer, and after a flush it is always resolved (no hangs)."""

    def __init__(self, server: "ForestServer", n_rows: int,
                 model_id: int = 0, deadline: float | None = None):
        self._server = server
        self.n_rows = n_rows
        self.model_id = model_id
        self.deadline = deadline
        self._out: np.ndarray | None = None
        self._err: Exception | None = None

    def done(self) -> bool:
        return self._out is not None or self._err is not None

    def exception(self) -> Exception | None:
        """The resolving error, if the request failed (None otherwise)."""
        return self._err

    def _set(self, out: np.ndarray):
        self._out = out

    def _set_error(self, err: Exception):
        self._err = err

    def result(self) -> np.ndarray:
        if not self.done():
            self._server.flush()
        if self._err is not None:
            raise self._err
        return self._out


class ForestServer:
    """Bucketed micro-batch server over a ``ModelRegistry``.

    ``predict`` is the synchronous one-shot path (used by the latency
    measurement); ``submit`` / ``tick`` / ``flush`` is the queued path.
    ``compile_count`` is the number of serve executables (CUDA graphs on
    the card) built so far -- the (bucket, model-set) capture contract
    made measurable."""

    def __init__(self, registry: ModelRegistry,
                 policy: BatchPolicy | None = None,
                 admission: AdmissionPolicy | None = None,
                 breaker: CircuitBreaker | None = None,
                 fault_injector=None, sleep=None):
        self.registry = registry
        self.policy = policy or BatchPolicy()
        self.admission = admission or AdmissionPolicy()
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # fault_injector(site, attempt) is the chaos harness's hook into
        # the executor path (raises TransientServeError to simulate a
        # transient failure); sleep is injectable so backoff tests and the
        # chaos scenario never actually wait.
        self.fault_injector = fault_injector
        self._sleep = sleep if sleep is not None else time.sleep
        self._exec: dict = {}          # (bucket, shape_sig) -> ServeGraph
        self.compile_count = 0
        self.stats = dict(batches=0, rows=0, padded_rows=0, requests=0,
                          rejected_full=0, rejected_open=0, shed=0,
                          retries=0, nonfinite=0)
        self._queue: list = []         # (gids [n], rows [n,K], pending, t)

    @property
    def pending_rows(self) -> int:
        """Rows currently queued (the admission-bound quantity)."""
        return sum(q[0].shape[0] for q in self._queue)

    # -- bucket selection --------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n.  Callers chunk to the largest bucket
        first, so n <= max(buckets) here."""
        for b in self.policy.buckets:
            if n <= b:
                return b
        raise ValueError(f"chunk of {n} rows exceeds largest bucket "
                         f"{self.policy.buckets[-1]}")

    # -- capture cache -----------------------------------------------------

    def _get_exec(self, bucket: int) -> ServeGraph:
        sig = self.registry.shape_sig
        entry = self._exec.get((bucket, sig))
        if entry is None:
            # the envelope grew: graphs of an older signature read freed
            # tables, so they go before the new capture
            self._exec = {k: v for k, v in self._exec.items()
                          if k[1] == sig}
            entry = serve_graph(self.registry, bucket)
            self._exec[(bucket, sig)] = entry
            self.compile_count += 1
        return entry

    def _execute(self, gids: np.ndarray, rows: np.ndarray) -> tuple:
        """Run one chunk: pad to its bucket, replay, slice the pad away.
        Returns ``(out [n] f32, ok [n] bool)`` -- the walk's finiteness
        lane rides along with the predictions."""
        n = rows.shape[0]
        bucket = self.bucket_for(n)
        if n < bucket:
            rows = np.pad(rows, ((0, bucket - n), (0, 0)))
            gids = np.pad(gids, (0, bucket - n))
        out, ok = self._get_exec(bucket).run(
            np.ascontiguousarray(gids, dtype=np.int32),
            np.ascontiguousarray(rows, dtype=np.int32))
        self.stats["batches"] += 1
        self.stats["rows"] += n
        self.stats["padded_rows"] += bucket - n
        return out[:n], ok[:n]

    def _run(self, gids: np.ndarray, rows: np.ndarray) -> tuple:
        """Chunk a (possibly oversize) row block through the buckets."""
        cap = self.policy.buckets[-1]
        outs, oks = [], []
        for i in range(0, rows.shape[0], cap):
            o, k = self._execute(gids[i:i + cap], rows[i:i + cap])
            outs.append(o)
            oks.append(k)
        if not outs:
            return np.zeros((0,), np.float32), np.zeros((0,), bool)
        return np.concatenate(outs), np.concatenate(oks)

    def _run_with_retry(self, gids: np.ndarray, rows: np.ndarray) -> tuple:
        """``_run`` under the admission policy's retry budget: transient
        failures (injected ``TransientServeError`` or RuntimeErrors from
        the executor) back off ``backoff_base * 2**i`` and retry;
        exhaustion raises ``RetriesExhaustedError`` with the last cause.
        A CUDA error is sticky: a real device fault fails every attempt,
        exhausts the retries and surfaces as ``RetriesExhaustedError``."""
        last: BaseException | None = None
        for attempt in range(self.admission.max_attempts):
            if attempt:
                self.stats["retries"] += 1
                self._sleep(self.admission.backoff_base * 2 ** (attempt - 1))
            try:
                if self.fault_injector is not None:
                    self.fault_injector("execute", attempt)
                return self._run(gids, rows)
            except (TransientServeError, RuntimeError) as e:
                if isinstance(e, RetriesExhaustedError):
                    raise
                last = e
        raise RetriesExhaustedError(self.admission.max_attempts, last)

    # -- queued serving ----------------------------------------------------

    def submit(self, model_id: int, bins, now: float | None = None,
               deadline: float | None = None) -> PendingRequest:
        """Queue one request (``bins`` [n, k_model]); flushes immediately
        once ``max_batch`` rows are pending.  ``now`` injects a timestamp
        for deterministic tests (defaults to ``time.monotonic()``);
        ``deadline`` (seconds from now) overrides the admission policy's
        default.  Raises ``TenantUnavailableError`` while the tenant's
        circuit breaker is open, ``QueueFullError`` past the admission
        bound -- both explicit and retryable, never an unbounded queue."""
        if (not 0 <= model_id < len(self.registry.tenants)
                or self.registry.tenants[model_id] is None):
            raise ValueError(f"unknown model_id {model_id}")
        now_t = time.monotonic() if now is None else now
        if not self.breaker.allow(model_id, now_t):
            self.stats["rejected_open"] += 1
            raise TenantUnavailableError(
                model_id,
                f"tenant {model_id} is quarantined (circuit "
                f"{self.breaker.state(model_id)} after non-finite "
                "outputs); retry after the breaker cooldown — other "
                "tenants are unaffected")
        rows = self.registry.pad_bins(bins)
        n = rows.shape[0]
        if self.pending_rows + n > self.admission.max_pending_rows:
            self.stats["rejected_full"] += 1
            raise QueueFullError(
                f"admission queue full: {self.pending_rows} rows pending "
                f"+ {n} requested > max_pending_rows="
                f"{self.admission.max_pending_rows}; flush (or tick) and "
                "resubmit")
        dl = deadline if deadline is not None else self.admission.deadline
        pending = PendingRequest(
            self, n, model_id=model_id,
            deadline=None if dl is None else now_t + dl)
        gids = np.full((n,), model_id, dtype=np.int32)
        self._queue.append((gids, rows, pending, now_t))
        self.stats["requests"] += 1
        if self.pending_rows >= self.policy.max_batch:
            self.flush(now=now_t)
        return pending

    def tick(self, now: float | None = None):
        """Flush if the oldest queued request has aged past max_delay."""
        if not self._queue:
            return
        now = time.monotonic() if now is None else now
        if now - self._queue[0][3] >= self.policy.max_delay:
            self.flush(now=now)

    def flush(self, now: float | None = None):
        """Drain the queue: shed requests past their deadline (explicit
        ``DeadlineExceededError``, never a late answer), then run one
        concatenated mixed-tenant batch -- chunked and padded to buckets,
        retried under the admission policy -- and slice outputs back per
        request.  Requests whose rows fail the walk's finiteness lane
        resolve to ``NonFiniteOutputError`` and trip their tenant's
        breaker; finite requests in the same batch are served normally."""
        if not self._queue:
            return
        now_t = time.monotonic() if now is None else now
        batch, self._queue = self._queue, []
        live = []
        for q in batch:
            pending = q[2]
            if pending.deadline is not None and now_t > pending.deadline:
                self.stats["shed"] += 1
                pending._set_error(DeadlineExceededError(
                    f"request shed un-executed: queued at t={q[3]:.6f}, "
                    f"deadline t={pending.deadline:.6f}, flushed at "
                    f"t={now_t:.6f}"))
            else:
                live.append(q)
        if not live:
            return
        gids = np.concatenate([q[0] for q in live])
        rows = np.concatenate([q[1] for q in live])
        try:
            out, ok = self._run_with_retry(gids, rows)
        except RetriesExhaustedError as e:
            for q in live:
                q[2]._set_error(e)
            return
        ofs = 0
        for _, r, pending, _ in live:
            n = r.shape[0]
            o, fin = out[ofs:ofs + n], ok[ofs:ofs + n]
            ofs += n
            if fin.all():
                pending._set(o)
                self.breaker.record_success(pending.model_id)
            elif self.breaker.enabled:
                self.stats["nonfinite"] += 1
                self.breaker.record_failure(pending.model_id, now_t)
                pending._set_error(NonFiniteOutputError(
                    pending.model_id,
                    f"tenant {pending.model_id} produced "
                    f"{int((~fin).sum())}/{n} non-finite outputs (poisoned "
                    "tables?); withholding results and opening its "
                    "circuit breaker"))
            else:
                # breaker disabled: legacy silent-NaN behaviour -- the
                # chaos scenario injects a poisoned tenant and fails on this
                self.stats["nonfinite"] += 1
                pending._set(o)

    def predict(self, model_id: int, bins) -> np.ndarray:
        """Synchronous one-shot: enqueue, flush, return (the latency
        measurement's steady-state hot path)."""
        pending = self.submit(model_id, bins)
        self.flush()
        return pending.result()
