"""repro_torch.check -- the port's performance contracts, checked on
recordings of its real hot paths.

The counterpart of ``repro.check``.  Every structural performance claim of
the port (no host round-trip in a level step, one histogram-sized
collective per level, one scalar pmax per GOSS draw, one int32 psum per
grid, a serve bucket on static buffers, the histogram really is the
kernel) is a claim about what one call of the function does:

* :mod:`repro_torch.check.recorder` -- ``record(fn, *args, device=...)``:
  one call of the real function, with every aten op, collective, kernel
  launch and host sync it makes (on fake ``cuda`` tensors on the CPU, for
  real on the card).
* :mod:`repro_torch.check.rules` -- the reference's six rules over a
  recording (``StaticBuffers`` and ``KernelBudget`` in place of donation
  and VMEM budgets).
* :mod:`repro_torch.check.contracts` -- the eleven ``@contract``
  declarations at the reference's smoke shapes.
* ``python -m repro_torch.check`` -- the gate: a pass/fail table, nonzero
  exit on any violation.
"""
from repro_torch.check.recorder import Launch, Op, Surface, record
from repro_torch.check.rules import (BANNED_GATHER_PRIMS, COLLECTIVE_PRIMS,
                                     PORT_OPS, CollectiveBudget, DTypePolicy,
                                     KernelBudget, NoDynamicShapes,
                                     NoHostTransfer, Rule, StaticBuffers,
                                     Violation, prim_of, run_rules)

__all__ = [
    "BANNED_GATHER_PRIMS", "COLLECTIVE_PRIMS", "PORT_OPS",
    "CollectiveBudget", "DTypePolicy", "KernelBudget", "Launch",
    "NoDynamicShapes", "NoHostTransfer", "Op", "Rule", "StaticBuffers",
    "Surface", "Violation", "prim_of", "record", "run_rules",
]
