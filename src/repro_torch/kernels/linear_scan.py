"""The linear recurrence ``h_t = a_t * h_{t-1} + b_t`` (``h_{-1} = 0``)
over the time axis of ``[B, T, D]``, and its backward: the CUDA kernels'
wrappers, their plain PyTorch versions, and the op the LM's recurrent
blocks call (``models/rglru.py::_scan_linear_recurrence``: the RG-LRU and
the sLSTM).

The reference runs the recurrence with ``jax.lax.associative_scan``
(``repro.models.rglru._scan_linear_recurrence``, the sLSTM's scans in
``repro.models.xlstm.slstm_block``); no Pallas kernel.  The port runs it
in order over ``t``, which rounds as a per-position loop does (within the
reference's 1e-4 of XLA's tree).

``linear_scan(a, b)`` takes contiguous f32 ``[B, T, D]`` operands on one
CPU or CUDA device (checked once: by ``linear_scan`` off the card, by the
CUDA wrapper or the fake launch on it) and calls
``torch.ops.repro_torch.linear_scan``, a ``torch.library.custom_op``:

  * on a CUDA tensor, ``linear_scan_cuda`` launches ``csrc/linear_scan.cu``
    by the launch plan ``scan_plan`` gives (below);
  * on a CPU tensor, ``linear_scan_plain`` runs the per-position loop;
  * its fake implementation gives the output's shape;
  * its backward is ``torch.ops.repro_torch.linear_scan_backward`` (the same
    two routes: ``linear_scan_backward_cuda`` / ``_plain``), one reverse
    scan: ``lam_{T-1} = g_{T-1}``, ``lam_t = g_t + a_{t+1} * lam_{t+1}``,
    ``db_t = lam_t``, ``da_t = lam_t * h_{t-1}``.

So a dispatch mode (``launch/analysis.count``, the dry run) sees one op
forward and one backward, with exactly their operands' bytes, on fake,
CPU and card tensors alike.  Every product and sum is one rounding in the
order written, so the kernels equal the plain loops bit for bit, and the
backward equals autograd through the forward loop.  There is no fallback:
a CUDA tensor launches a kernel or raises.  The plain versions take any
float dtype (the op is gradchecked in float64 on the CPU); the kernels take
float32.

The launch plan.  Both kernels walk each (b, d) channel over ``t`` in the
loop's order; what bounds them is the memory (3 B T D 4 bytes forward, 5
backward), so the design is about keeping bytes in flight ahead of the
walk (``csrc/linear_scan.cu`` says how).  ``scan_plan`` picks, from the
shape and the operands' alignment alone (so the CPU tests and the dry
run's fake launches see the card's numbers):

  * ``T >= SHORT_T`` (``SHORT_T_BACKWARD`` backward), ``D % 4 == 0`` and
    16-byte aligned operands: the staged walk.  A block is one warp and
    owns ``TILE`` = 32 channels of one batch row (grid ``B * ceil(D /
    32)``); the TMA streams the operands through a ring of ``stages``
    shared-memory stages of ``tc`` steps (one ``[tc, 32]`` f32 box an
    operand, plus ``RING_PAD`` to align the ring).  The ring's budget is
    what one wave of the grid may take of the card's shared memory
    (``SMEM_PER_SM`` on each of ``SM_COUNT`` SMs, ``BLOCK_RESERVED`` and
    the barriers of it a block), so every tile is resident at once, and at
    most ``RING_BYTES`` once there are more tiles than SMs (the memory is
    then the bound, and deeper rings measured slower); ``tc`` is the
    longest of ``STAGE_STEPS`` with two stages in the budget and ``T`` at
    least ``MIN_RING`` stages long (fewer tiles than SMs: a tile's rate
    is a round trip a stage, so longer stages pay), and ``stages`` as
    many as the budget holds, up to ``MAX_STAGES`` and the stages ``T``
    has, at least 2 where ``T`` has them.
  * otherwise the short walk, one thread a channel straight from global
    memory (``WALK_THREADS`` a block), no shared memory.  Decode runs
    T = 1.  The thresholds come from ``chip_smoke.py`` phase 3's sweep of
    both paths at ``[4, T, 2560]``, the ring's rule from
    ``tools/linear_scan_sweep.py`` (``PERF.md`` §6).

The kernel checks that the plan it is given is the one it can run.  The
plan's shared-memory bytes are what each launch reports to
``_checks.report`` (``check/rules.py::KernelBudget`` holds them against the
card's opt-in limit), the fake launch's too.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import _build, _checks
from repro_torch.kernels._checks import need, stream_of

__all__ = ["linear_scan", "linear_scan_cuda", "linear_scan_backward_cuda",
           "linear_scan_plain", "linear_scan_backward_plain", "ScanPlan",
           "scan_plan", "plan_channels"]

# csrc/linear_scan.cu's kTile, kChunk, kMaxStages, kRingPad, kWalkThreads
TILE = 32                # staged walk: channels a block, one warp's lanes
CHUNK = 32               # steps a lane holds in registers (a stage's unit)
MAX_STAGES = 8
RING_PAD = 128           # the ring starts on a 128-byte boundary (the TMA's)
WALK_THREADS = 64        # short walk: threads a block
BARRIERS = 8 * MAX_STAGES     # static shared memory: a stage's mbarrier each
STAGE_STEPS = (256, 128, 64, 32)   # a stage's steps, the longest that fits
MIN_RING = 4             # ... with T at least this many stages long
# below these T the short walk (H100 80GB HBM3 at 700 W: chip_smoke.py's
# sweep at [4, T, 2560], forward walk faster to T = 24 and slower from 32,
# backward faster to T = 6 and slower from 8)
SHORT_T = 32
SHORT_T_BACKWARD = 8
# ring bytes a block once the tiles fill the SMs (tools/linear_scan_sweep.py:
# at 160 tiles 64x2 forward and 32x3 backward were best, deeper rings
# slower by up to 1.5x; below 132 tiles the per-tile rate rules and the
# longest stages that fit were best)
RING_BYTES = 40 * 1024
# the H100's: SMs, shared memory an SM, and of it reserved a block
SM_COUNT = 132
SMEM_PER_SM = 233472
BLOCK_RESERVED = 1024


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One launch of a linear-scan kernel: ``staged`` (else the short
    walk), ``threads`` a block, ``grid`` blocks, ``tile`` channels a block
    (the staged walk) and ``tc`` steps a stage, ``stages`` in the ring,
    ``smem`` dynamic shared-memory bytes."""
    staged: bool
    threads: int
    grid: int
    tile: int
    tc: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=1024)
def scan_plan(shape, backward=False, short_t=None,
              aligned=True) -> ScanPlan:
    """The launch plan of ``[B, T, D]`` (module docstring), cached: a
    launch's host time counts at T = 1.  ``short_t`` (default ``SHORT_T``,
    ``SHORT_T_BACKWARD``) moves the threshold (``chip_smoke.py`` times both
    paths with it).  The staged walk reads 16-byte rows: ``D % 4 == 0`` and
    ``aligned`` (every staged operand on a 16-byte boundary), else the
    short walk."""
    bsz, t_len, d = shape
    if short_t is None:
        short_t = SHORT_T_BACKWARD if backward else SHORT_T
    if t_len < short_t or d % 4 or not aligned:
        return ScanPlan(False, WALK_THREADS, -(-bsz * d // WALK_THREADS),
                        0, 0, 0, 0)
    grid = bsz * -(-d // TILE)
    per_sm = max(1, -(-grid // SM_COUNT))
    budget = SMEM_PER_SM // per_sm - BLOCK_RESERVED - BARRIERS - RING_PAD
    if grid > SM_COUNT:
        budget = min(budget, RING_BYTES)

    def box(tc):
        return (3 if backward else 2) * tc * TILE * 4

    tc = next((tc for tc in STAGE_STEPS
               if t_len >= MIN_RING * tc and budget >= 2 * box(tc)),
              STAGE_STEPS[-1])
    stages = min(MAX_STAGES, -(-t_len // tc), max(2, budget // box(tc)))
    return ScanPlan(True, TILE, grid, TILE, tc, stages,
                    stages * box(tc) + RING_PAD)


def _aligned(*ptrs) -> bool:
    return all(p % 16 == 0 for p in ptrs)


def plan_channels(plan: ScanPlan, bsz: int, d: int) -> np.ndarray:
    """``[grid, threads]``: the flat channel ``b * D + d`` each thread of
    the plan walks, -1 for none (the kernels' index map)."""
    blk = np.arange(plan.grid, dtype=np.int64)[:, None]
    lane = np.arange(plan.threads, dtype=np.int64)[None, :]
    if not plan.staged:
        ch = blk * plan.threads + lane
        return np.where(ch < bsz * d, ch, -1)
    per_row = -(-d // plan.tile)
    col = (blk % per_row) * plan.tile + lane
    return np.where(col < d, (blk // per_row) * d + col, -1)


@torch.no_grad()
def linear_scan_plain(a, b):
    """The per-position loop: ``h_t = a_t * h_{t-1} + b_t``, a product then
    a sum, each rounded, a step."""
    h = torch.empty_like(b)
    if b.shape[1]:
        acc = torch.zeros_like(b[:, 0])
        for t in range(b.shape[1]):
            acc = a[:, t] * acc + b[:, t]
            h[:, t] = acc
    return h


@torch.no_grad()
def linear_scan_backward_plain(a, h, g):
    """(da, db) of ``linear_scan_plain`` from ``a``, its output ``h`` and the
    output's gradient ``g``: the reverse loop (module docstring)."""
    da, db = torch.empty_like(g), torch.empty_like(g)
    t_len = g.shape[1]
    for t in range(t_len - 1, -1, -1):
        lam = g[:, t] if t == t_len - 1 else g[:, t] + a[:, t + 1] * lam
        db[:, t] = lam
        da[:, t] = lam * (h[:, t - 1] if t else torch.zeros_like(lam))
    return da, db


def _operands(tensors, names):
    """Check contiguous f32 ``[B, T, D]`` operands of one shape on one CPU
    or CUDA device; their data pointers (0 for fake tensors)."""
    first = tensors[0]
    if not isinstance(first, torch.Tensor) or first.dim() != 3:
        raise ValueError(f"{names[0]}: expected a [B, T, D] tensor, got "
                         f"{getattr(first, 'shape', type(first).__name__)}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{names[0]}: on {first.device}; linear_scan runs "
                         "on the CPU or a CUDA device")
    return [need(t, n, torch.float32, tuple(first.shape), first.device)
            for t, n in zip(tensors, names)]


def _plan_args(plan: ScanPlan):
    return (int(plan.staged), plan.tc, plan.stages, plan.smem, plan.grid)


def linear_scan_cuda(a, b, plan=None):
    """Launch the forward kernel on the current stream by ``plan``
    (default: ``scan_plan`` of the shape and the operands' alignment).  ``linear_scan_cuda.launches`` counts
    its launches."""
    stream = stream_of(b.device)
    pa, pb = _operands((a, b), ("a", "b"))
    plan = plan or scan_plan(b.shape, aligned=_aligned(pa, pb))
    h = torch.empty_like(b)
    if h.numel():
        lib = _build.library()
        _build.check(lib.udt_linear_scan(pa, pb, h.data_ptr(), *b.shape,
                                         *_plan_args(plan), stream),
                     "linear scan")
        linear_scan_cuda.launches += 1
        _checks.report("linear_scan", (), lambda: plan.smem)
    return h


def linear_scan_backward_cuda(a, h, g, plan=None):
    """Launch the backward kernel on the current stream by ``plan``
    (default: ``scan_plan`` of the shape and the operands' alignment):
    (da, db).
    ``linear_scan_backward_cuda.launches`` counts its launches."""
    stream = stream_of(g.device)
    pg, pa, ph = _operands((g, a, h), ("g", "a", "h"))
    plan = plan or scan_plan(g.shape, backward=True,
                             aligned=_aligned(pa, ph, pg))
    da, db = torch.empty_like(g), torch.empty_like(g)
    if g.numel():
        lib = _build.library()
        _build.check(lib.udt_linear_scan_backward(
            pa, ph, pg, da.data_ptr(), db.data_ptr(), *g.shape,
            *_plan_args(plan), stream), "linear scan backward")
        linear_scan_backward_cuda.launches += 1
        _checks.report("linear_scan_backward", (), lambda: plan.smem)
    return da, db


linear_scan_cuda.launches = 0
linear_scan_backward_cuda.launches = 0


@torch.library.custom_op("repro_torch::linear_scan", mutates_args=(),
                         device_types="cpu")
def _scan_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return linear_scan_plain(a, b)


@_scan_op.register_kernel("cuda")
def _(a, b):
    return linear_scan_cuda(a, b)


@_scan_op.register_fake
def _(a, b):
    if b.device.type == "cuda":        # the launch the card would make
        _operands((a, b), ("a", "b"))
        if b.numel():
            _checks.report("linear_scan", (),
                           lambda: scan_plan(b.shape).smem)
    return torch.empty_like(b)


@torch.library.custom_op("repro_torch::linear_scan_backward",
                         mutates_args=(), device_types="cpu")
def _scan_backward_op(a: torch.Tensor, h: torch.Tensor,
                      g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return linear_scan_backward_plain(a, h, g)


@_scan_backward_op.register_kernel("cuda")
def _(a, h, g):
    return linear_scan_backward_cuda(a, h, g)


@_scan_backward_op.register_fake
def _(a, h, g):
    if g.device.type == "cuda":
        _operands((g, a, h), ("g", "a", "h"))
        if g.numel():
            _checks.report("linear_scan_backward", (),
                           lambda: scan_plan(g.shape, backward=True).smem)
    return torch.empty_like(g), torch.empty_like(g)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output)


def _backward(ctx, g):
    a, h = ctx.saved_tensors
    return _scan_backward_op(a, h, g.contiguous())


_scan_op.register_autograd(_backward, setup_context=_setup_context)


def linear_scan(a, b):
    """``h`` with ``h_t = a_t * h_{t-1} + b_t`` over axis 1, ``h_{-1} = 0``:
    one op forward and one backward (module docstring).  ``a`` and ``b``
    are contiguous f32 ``[B, T, D]`` on one device: checked here off the
    card, by ``linear_scan_cuda`` (or the fake launch) on it."""
    if b.device.type != "cuda":
        _operands((a, b), ("a", "b"))
    return _scan_op(a, b)
