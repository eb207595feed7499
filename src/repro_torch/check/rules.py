"""Performance-contract rules checked against recorded surfaces.

The port's counterpart of ``repro.check.rules``: the same six rules, the
same names, ``describe()`` texts and violation messages wherever they
still apply, read off a ``recorder.Surface`` instead of a jaxpr.

* :class:`CollectiveBudget` -- which collectives a surface may make, how
  many of each, at what operand dtype and rank.  Its keys are the
  reference's primitive names, mapped onto the port's calls
  (``PORT_OPS``); a call to ``torch.distributed`` past ``Collectives`` is
  never allowed.
* :class:`NoHostTransfer` -- no host sync and no device-to-host copy.
* :class:`DTypePolicy` -- no float64 / complex anywhere.
* :class:`NoDynamicShapes` -- no op whose output shape depends on data.
* :class:`StaticBuffers` (for the reference's ``DonationCheck``: CUDA
  graphs have no donation) -- the serve bucket's input buffers are the
  ones every run writes, a graph was captured, a replay allocates nothing.
* :class:`KernelBudget` (for ``ScratchBudget``) -- every launch's dynamic
  shared memory fits the card's opt-in limit per block, and optionally a
  named kernel did launch.

A rule that needs the card for part of its check says what it could not
check in ``unchecked(surface)`` ("n/a on cpu"); it never passes that part.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

from repro_torch.check.recorder import Surface

__all__ = ["Rule", "Violation", "CollectiveBudget", "NoHostTransfer",
           "DTypePolicy", "NoDynamicShapes", "StaticBuffers", "KernelBudget",
           "COLLECTIVE_PRIMS", "BANNED_GATHER_PRIMS", "PORT_OPS", "prim_of",
           "run_rules"]

# the reference's collective primitive names (``repro.check.rules``)
COLLECTIVE_PRIMS = frozenset({
    "psum", "pmax", "pmin", "pbroadcast", "ppermute", "pgather",
    "all_to_all", "all_gather", "all_gather_invariant",
    "reduce_scatter", "psum_scatter", "ragged_all_to_all",
})
BANNED_GATHER_PRIMS = frozenset({
    "all_to_all", "ppermute", "pgather",
    "all_gather", "all_gather_invariant", "ragged_all_to_all",
})
# (Collectives operation, reduce op) -> the reference's primitive name
PORT_OPS = {
    ("all_reduce", "sum"): "psum",
    ("all_reduce", "max"): "pmax",
    ("reduce_scatter_tensor", "sum"): "reduce_scatter",
    ("all_gather_into_tensor", None): "all_gather",
    ("all_to_all_single", None): "all_to_all",
}


def prim_of(call) -> str:
    """The reference's primitive name of one ``Collectives`` call (its own
    operation name when it has none, e.g. a direct ``torch.distributed``
    call)."""
    return PORT_OPS.get((call.op, call.reduce), call.op)


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.message}"


class Rule:
    """Base class: ``check(surface) -> list[Violation]``."""

    name = "rule"

    def check(self, surface: Surface) -> list[Violation]:
        raise NotImplementedError

    def unchecked(self, surface: Surface) -> str | None:
        """What of this rule only the card can check, when ``surface`` was
        recorded on the CPU (None: all of it was checked)."""
        return None

    def _v(self, message: str) -> Violation:
        return Violation(self.name, message)

    def describe(self) -> str:
        """One-line human summary for the contract table."""
        return self.name


class CollectiveBudget(Rule):
    """Allowed collectives with per-primitive budgets; any other
    collective call is a violation.

    ``allowed`` maps a reference primitive name to an int max count or a
    dict with optional keys ``max``, ``dtype`` (operand dtype prefix),
    ``scalar`` (rank-0 operands) and ``max_rank``.  ``max_bulk`` caps the
    calls (of any allowed kind) whose operand has rank >= ``bulk_rank``.
    The rank is that of the operand as the port hands it in.

    A recording counts calls as they run, a jaxpr as they are traced: a
    surface that runs a loop of ``steps`` iterations (the reference traces
    its body once) may make ``steps`` times the budget."""

    name = "collective-budget"

    def __init__(self, allowed: dict[str, Any] | None = None, *,
                 max_bulk: int | None = None, bulk_rank: int = 4,
                 steps: int = 1):
        self.allowed = {k: ({"max": v} if isinstance(v, int) else dict(v))
                        for k, v in (allowed or {}).items()}
        self.max_bulk = max_bulk
        self.bulk_rank = bulk_rank
        self.steps = steps

    def describe(self) -> str:
        if not self.allowed:
            return "no collectives"
        parts = []
        for prim, spec in sorted(self.allowed.items()):
            p = prim
            if "max" in spec:
                p += f" x{spec['max']}"
            if spec.get("dtype"):
                p += f" {spec['dtype']}"
            if spec.get("scalar"):
                p += " scalar"
            parts.append(p)
        s = ", ".join(parts)
        if self.max_bulk is not None:
            s += f"; <={self.max_bulk} bulk (rank>={self.bulk_rank})"
        if self.steps > 1:
            s += f" a step ({self.steps} steps)"
        return s

    def check(self, surface: Surface) -> list[Violation]:
        out, counts, bulk = [], {}, 0
        for call in surface.collectives:
            prim = prim_of(call)
            if prim not in self.allowed:
                out.append(self._v(f"banned collective: {prim}"))
                continue
            spec = self.allowed[prim]
            counts[prim] = counts.get(prim, 0) + 1
            nd = len(call.shape)
            if spec.get("scalar") and nd != 0:
                out.append(self._v(
                    f"{prim} operand must be scalar, got rank {nd}"))
            if "max_rank" in spec and nd > spec["max_rank"]:
                out.append(self._v(
                    f"{prim} operand rank {nd} > max_rank {spec['max_rank']}"))
            dt = spec.get("dtype")
            if dt and not call.dtype.startswith(dt):
                out.append(self._v(
                    f"{prim} operand dtype {call.dtype}, contract says {dt}"))
            if nd >= self.bulk_rank:
                bulk += 1
        for prim, spec in self.allowed.items():
            if "max" in spec and counts.get(prim, 0) > spec["max"] * self.steps:
                out.append(self._v(
                    f"{prim} appears {counts[prim]}x, budget "
                    f"{spec['max'] * self.steps}"))
        if self.max_bulk is not None and bulk > self.max_bulk * self.steps:
            out.append(self._v(
                f"{bulk} bulk collectives (operand rank >= "
                f"{self.bulk_rank}), budget {self.max_bulk * self.steps}"))
        return out


class NoHostTransfer(Rule):
    """No host sync and no device-to-host copy in the recording.

    On the card an implicit sync raises inside the recording
    (``set_sync_debug_mode("error")``) and on the CPU a host read of a fake
    value raises: the runner reports either as a trace failure, still a
    violation of this contract.  What is recorded without raising (a
    ``.cpu()`` copy on the CPU, a non-blocking copy to the host, an
    explicit ``synchronize``) is flagged here."""

    name = "no-host-transfer"

    def describe(self) -> str:
        return "no host callbacks / transfers"

    def check(self, surface: Surface) -> list[Violation]:
        return [self._v(f"host transfer: {h}") for h in surface.host]


class DTypePolicy(Rule):
    """No op of the recording may take or give a banned dtype (default:
    float64 and complex)."""

    name = "dtype-policy"

    def __init__(self, banned: Iterable[str] = ("float64", "complex64",
                                                "complex128")):
        self.banned = tuple(banned)

    def describe(self) -> str:
        return "no " + "/".join(self.banned)

    def check(self, surface: Surface) -> list[Violation]:
        hits = {dt for op in surface.ops for dt in op.dtypes
                if dt in self.banned}
        return [self._v(f"banned dtype in trace: {dt}")
                for dt in sorted(hits)]


class NoDynamicShapes(Rule):
    """No op whose output shape depends on the data: one capture and one
    allocation pattern serve every call of a shape."""

    name = "no-dynamic-shapes"

    def describe(self) -> str:
        return "all shapes static"

    def check(self, surface: Surface) -> list[Violation]:
        return [self._v(f"data-dependent output shape: {op}")
                for op in surface.dynamic]


class StaticBuffers(Rule):
    """The serve bucket's executable reads static buffers: the ``bins`` /
    ``gids`` tensors ``serve_graph`` made are the ones two
    ``ServeGraph.run`` calls write (same ``data_ptr``), and on the card a
    graph was captured and a replay allocates no device block.  Reads
    ``surface.facts["buffers"]``."""

    name = "static-buffers"

    def describe(self) -> str:
        return "static input buffers, captured graph, replay allocates 0"

    def unchecked(self, surface: Surface) -> str | None:
        if surface.device != "cuda":
            return "graph capture and replay allocations n/a on cpu"
        return None

    def check(self, surface: Surface) -> list[Violation]:
        facts = surface.facts.get("buffers")
        if facts is None:
            return [self._v("no buffer facts on the surface (the contract "
                            "must run the bucket)")]
        out = []
        if not facts["same_buffers"]:
            out.append(self._v("ServeGraph.run wrote other buffers than the "
                               "ones serve_graph made"))
        if surface.device == "cuda":
            if not facts["graph"]:
                out.append(self._v("no CUDA graph captured"))
            if facts["replay_allocs"]:
                out.append(self._v(f"a replay allocated "
                                   f"{facts['replay_allocs']} device blocks"))
        return out


def _optin_smem() -> int:
    import torch
    dev = torch.cuda.current_device()
    return int(torch.cuda.get_device_properties(dev)
               .shared_memory_per_block_optin)


class KernelBudget(Rule):
    """Every recorded launch's dynamic shared memory is at most the card's
    opt-in limit per block (``cap_bytes``, read from the card when None).
    With ``require_kernel`` the surface must launch that kernel at least
    once -- the cheap path IS the recorded path, not a plain fallback."""

    name = "kernel-budget"

    def __init__(self, cap_bytes: int | None = None, *,
                 require_kernel: str | None = None):
        self.cap_bytes = cap_bytes
        self.require_kernel = require_kernel

    def describe(self) -> str:
        cap = ("the card's opt-in limit" if self.cap_bytes is None
               else f"{self.cap_bytes} B")
        s = f"kernel shared memory <= {cap}"
        if self.require_kernel:
            s += f", {self.require_kernel} kernel required"
        return s

    def unchecked(self, surface: Surface) -> str | None:
        if any(lc.smem is None for lc in surface.launches):
            return "shared memory n/a on cpu"
        return None

    def check(self, surface: Surface) -> list[Violation]:
        out = []
        sized = [lc for lc in surface.launches if lc.smem is not None]
        cap = self.cap_bytes
        if cap is None and sized:
            cap = _optin_smem()
        for lc in sized:
            if lc.smem > cap:
                out.append(self._v(f"{lc.kernel} launch uses {lc.smem} B of "
                                   f"shared memory > cap {cap} B"))
        if self.require_kernel and not any(
                lc.kernel == self.require_kernel for lc in surface.launches):
            out.append(self._v(f"no {self.require_kernel} launch in trace -- "
                               f"kernel path fell back to plain torch"))
        return out


def run_rules(rules: Iterable[Rule], surface: Surface) -> list[Violation]:
    """Apply every rule to one surface; concatenated violations."""
    out: list[Violation] = []
    for rule in rules:
        out.extend(rule.check(surface))
    return out
