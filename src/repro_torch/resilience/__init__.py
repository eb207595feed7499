"""Resilience of the port (counterpart of ``repro.resilience``): fault
injection, the chaos scenario and the degradation surface, as one
namespace:

  * preemption-safe resume -- ``repro_torch.checkpoint`` round
    checkpoints consumed by ``GradientBoostedTrees.fit(resume_from=...)``;
  * graceful serving degradation -- ``repro_torch.serve.degrade``
    policies wired through ``ForestServer``;
  * deterministic chaos -- :mod:`repro_torch.resilience.inject` fault
    plans and :func:`repro_torch.resilience.harness.run_chaos`.
"""
from repro_torch.checkpoint.round_ckpt import (  # noqa: F401
    CheckpointCorruptError, CheckpointMismatchError, RoundCheckpoint,
    RoundCheckpointer, RoundState, fit_digest, restore_round_state,
)
from repro_torch.serve.degrade import (  # noqa: F401
    AdmissionPolicy, CircuitBreaker, DeadlineExceededError,
    NonFiniteOutputError, QueueFullError, RetriesExhaustedError,
    ServeError, TenantUnavailableError, TransientServeError,
)
from repro_torch.resilience.inject import (  # noqa: F401
    FaultPlan, PreemptedError, SkewClock, TransientFaults, chain,
    corrupt_checkpoint, kill_at_round, make_plan, poison_labels,
    poison_tenant, preempt_at_round,
)
from repro_torch.resilience.harness import run_chaos  # noqa: F401
