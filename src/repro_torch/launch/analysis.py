"""Roofline terms of one recorded step (counterpart of
``repro.launch.analysis``).

Terms per (arch x shape x mesh), in SECONDS on one card of the target part,
an NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet; dense rates):
    compute    = FLOPs / 989e12           (bf16 tensor-core peak)
    memory     = bytes / 3.35e12          (HBM3)
    collective = collective_bytes / 50e9  (per card: NDR InfiniBand at
                                           400 Gb/s)
``LINK_BW`` is the slowest link a ring of the 16 x 16 production mesh
crosses: 256 cards are 32 nodes of 8, joined by InfiniBand.  A group inside
one node would run over NVLink at 450e9 B/s a direction; one constant is
kept, as in the reference.  The card these numbers are held against in
``chip_smoke.py`` phase ``dryrun`` is an "NVIDIA H100 80GB HBM3, 700.00 W"
(``nvidia-smi --query-gpu=name,power.limit``).

The reference reads its counts off an XLA executable (``cost_analysis``,
``memory_analysis`` and the HLO text).  The port runs eager, so it counts
what one call dispatches instead (``count``): the call runs once under a
``TorchDispatchMode`` stacked with ``torch.utils.flop_counter.
FlopCounterMode``, on real tensors or on fake ones (``FakeTensorMode``:
shapes and dtypes, no data, nothing allocated).  What each field means here:

  * ``flops``: ``FlopCounterMode``'s total (matrix products, convolutions,
    attention).  XLA's count also has the elementwise ops, so the dry
    run's ``model_vs_hlo`` keeps its name and reads "model FLOPs / counted
    FLOPs".
  * ``bytes_accessed``: the sum, over every dispatched aten op that is not
    a view or a bare allocation, of the bytes of its tensor inputs and
    outputs (an in-place op reads and writes its operand).  Each eager op
    reads and writes device memory; where the L2 cache keeps an operand
    between two ops the card moves fewer bytes than this.  A scratch
    buffer that only an op's CPU kernel fills (``_CPU_SCRATCH``) is left
    out, so a recording on fake CPU tensors counts what the card does.
  * ``memory``: ``argument_bytes`` the distinct storages of the call's
    tensor arguments; ``output_bytes`` those of what it returns;
    ``alias_bytes`` the returned storages that are arguments the call
    wrote in place (the port's counterpart of donation: the train step
    writes the parameters and moments in place); ``temp_bytes`` the peak,
    during the call, of the storages it created and still held (a storage
    is counted from the op that makes it until its last reference dies,
    once however many views it has).
  * ``collectives``: the ring traffic of the ``Collectives.log`` the call
    made (``collective_bytes``).

``collective_bytes`` keeps the reference's ring convention per call:
all-reduce 2x its operand, all-gather its output (operand x group),
reduce-scatter its input, all-to-all its operand (the output too: every
exchange of the LM has equal counts); a call among one rank moves
nothing (XLA elides such a collective).  One difference is known:
``Collectives`` reduces over several axes one axis at a time, so a psum
over ``(data, model)`` logs two calls where XLA emits one all-reduce over
the combined group.  The port's term counts what the port does.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "Roofline",
           "collective_bytes", "analyze", "corrected",
           "serve_seconds_lower_bound", "model_flops", "count"]

PEAK_FLOPS = 989e12          # bf16 dense per card (H100 SXM5)
HBM_BW = 3.35e12             # bytes/s per card (HBM3)
LINK_BW = 50e9               # bytes/s per card (NDR InfiniBand, 400 Gb/s)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_RING_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

# Collectives' operation -> (kind, whether its traffic is operand x group);
# no operation of Collectives is a collective-permute yet
_KIND = {"all_reduce": ("all-reduce", False),
         "all_gather_into_tensor": ("all-gather", True),
         "reduce_scatter_tensor": ("reduce-scatter", False),
         "all_to_all_single": ("all-to-all", False),
         "collective_permute": ("collective-permute", False)}


def collective_bytes(log) -> dict:
    """Ring traffic per collective kind of a ``Collectives.log`` (a list of
    ``core.collectives.Call``), in the reference's keys plus ``total``."""
    out = {k: 0 for k in _COLLECTIVES}
    for call in log:
        if call.op not in _KIND:
            raise ValueError(f"no ring convention for {call.op!r}")
        if call.group == 1:       # among one rank: nothing crosses a link
            continue
        kind, gathered = _KIND[call.op]
        nbytes = call.nbytes * call.group if gathered else call.nbytes
        out[kind] += int(_RING_WEIGHT[kind] * nbytes)
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    chips: int
    per_device: bool = True      # a rank's recording is per device

    def terms(self):
        div = 1 if self.per_device else self.chips
        compute = self.flops / div / PEAK_FLOPS
        memory = self.bytes_accessed / div / HBM_BW
        collective = self.coll_bytes / div / LINK_BW
        dom = max((compute, "compute"), (memory, "memory"),
                  (collective, "collective"))
        return {
            "compute_s": compute,
            "memory_s": memory,
            "collective_s": collective,
            "bottleneck": dom[1],
            "step_lower_bound_s": max(compute, memory, collective),
        }


def analyze(counts: dict, chips: int) -> dict:
    """The reference's row fields from ``count``'s result (or a fit of
    several): ``flops``, ``bytes_accessed``, ``collectives``, ``memory``
    and the ``Roofline.terms`` of one rank."""
    coll = dict(counts["collectives"])
    r = Roofline(flops=float(counts["flops"]),
                 bytes_accessed=float(counts["bytes_accessed"]),
                 coll_bytes=float(coll["total"]), chips=chips)
    return {
        "flops": counts["flops"],
        "bytes_accessed": counts["bytes_accessed"],
        "collectives": coll,
        "memory": dict(counts["memory"]),
        **r.terms(),
    }


def corrected(raw: dict, body1: dict, body2: dict, n_groups: int) -> dict:
    """Depth correction: total = raw + (n_groups-1) * (body2 - body1)."""
    extra = max(0, n_groups - 1)

    def fix(key, sub=None):
        b = (body2["collectives"]["total"] - body1["collectives"]["total"]) \
            if sub else (body2[key] - body1[key])
        base = raw["collectives"]["total"] if sub else raw[key]
        return base + extra * max(0.0, b)

    flops = fix("flops")
    byts = fix("bytes_accessed")
    coll = fix(None, sub=True)
    r = Roofline(flops=flops, bytes_accessed=byts, coll_bytes=coll,
                 chips=raw.get("chips", 1))
    out = dict(raw)
    out.update({"flops": flops, "bytes_accessed": byts,
                "collective_bytes_corrected": coll, **r.terms()})
    return out


def serve_seconds_lower_bound(walk_bytes_request: float, requests: float,
                              chips: int = 1) -> float:
    """HBM-roofline lower bound on forest-serving time: the packed
    node-table bytes the walks must stream
    (``serve.pack.walk_bytes_per_request`` x requests) over the aggregate
    HBM bandwidth; shape arithmetic, never a wall clock."""
    return float(walk_bytes_request) * float(requests) / (chips * HBM_BW)


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    """Analytic 6*N_active*D (train fwd+bwd) or 2*N_active*D (inference)."""
    n = cfg.active_param_count()
    per_tok = 6 * n if shape_kind == "train" else 2 * n
    return per_tok * tokens


# ---------------------------------------------------------------------------
# the counting recording
# ---------------------------------------------------------------------------

# the namespaces of the ops counted: aten, and the port's own custom ops
# (``repro_torch::linear_scan`` and its backward, whose operands are the
# bytes their kernels move)
_COUNTED = frozenset({"aten", "repro_torch"})

# ops that move no bytes: bare allocations and the one view whose schema
# does not say so (the others are told by their schema)
_NO_TRAFFIC = frozenset({"aten.empty", "aten.empty_strided",
                         "aten.empty_like", "aten.new_empty",
                         "aten.new_empty_strided", "aten.lift_fresh",
                         "aten._unsafe_view"})


# a buffer that the CPU kernel of an op fills and the CUDA kernel leaves
# empty, left out on both devices so a fake CPU recording counts what the
# card does: op -> (index of the input, index of the output)
_CPU_SCRATCH = {"aten.log_sigmoid_forward": (None, 1),
                "aten.log_sigmoid_backward": (2, None)}


def _tensors_of(x) -> list:
    """Every tensor in ``x``: nested dicts, lists, tuples (named ones too)
    and modules (their parameters and buffers)."""
    if isinstance(x, torch.nn.Module):
        return list(x.parameters()) + list(x.buffers())
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors_of(v)]
    return []


def _storages(tensors) -> dict:
    """{storage key: bytes} of the distinct storages of ``tensors``."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


class _Counter(TorchDispatchMode):
    """Bytes, created storages and in-place writes of every aten op
    dispatched while it is active (``paused``: not the recording
    collectives' stand-in copies)."""

    def __init__(self, known: dict):
        super().__init__()
        self.known = dict(known)         # storages alive before the call
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.written: set = set()
        self.paused = 0

    def _made(self, st):
        key = st._cdata
        if key in self.known:
            return
        n = st.nbytes()
        self.known[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)

        def dead(counter=self, key=key, n=n):
            counter.known.pop(key, None)
            counter.live -= n
        weakref.finalize(st, dead)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused or func.namespace not in _COUNTED:
            return out
        schema = func._schema
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                for t in _tensors_of(v):
                    self.written.add(t.untyped_storage()._cdata)
        name = str(func.overloadpacket)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = _tensors_of(out)
        scratch_in, scratch_out = _CPU_SCRATCH.get(name, (None, None))
        if scratch_in is not None:
            del ins[scratch_in]
        if scratch_out is not None:
            del outs[scratch_out]
        for t in outs:
            self._made(t.untyped_storage())
        if func.is_view or name in _NO_TRAFFIC:
            return out
        self.ops += 1
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def count(fn, *args, comm=None, **kwargs) -> dict:
    """Call ``fn(*args, **kwargs)`` once and count it (module docstring):
    ``{"flops", "bytes_accessed", "collectives", "memory", "log", "ops"}``,
    ``log`` being the ``Collectives.log`` of ``comm`` (the collectives the
    call made through it; ``[]`` without one) and ``ops`` the aten ops
    counted.  Runs on whatever tensors it is given: fake ones when the
    caller holds a ``FakeTensorMode`` around the inputs and this call."""
    log = []
    arg_st = _storages(_tensors_of((args, kwargs)))
    counter = _Counter(arg_st)
    if comm is not None:
        old_log = comm.log
        comm.log = log
        inner = comm._exchange

        def exchange(*a, **kw):
            counter.paused += 1
            try:
                return inner(*a, **kw)
            finally:
                counter.paused -= 1
        comm._exchange = exchange
    try:
        with FlopCounterMode(display=False) as flops, counter:
            result = fn(*args, **kwargs)
    finally:
        if comm is not None:
            comm.log = old_log
            del comm._exchange          # the class's own again
    out_st = _storages(_tensors_of(result))
    alias = sum(n for k, n in out_st.items()
                if k in arg_st and k in counter.written)
    return {"flops": int(flops.get_total_flops()),
            "bytes_accessed": int(counter.bytes),
            "collectives": collective_bytes(log),
            "memory": {"argument_bytes": sum(arg_st.values()),
                       "output_bytes": sum(out_st.values()),
                       "temp_bytes": int(counter.peak),
                       "alias_bytes": alias},
            "log": log, "ops": counter.ops}
