#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version at the main path's shapes, and drives the
main path (bin once, grow a UDT level by level through the histogram and
split-scan kernels, predict) at KDD99-10% scale.

    python3 chip_smoke.py            # needs one CUDA card; ~6 minutes

Phases (any failure exits non-zero):
  1. device      card name, count, nvidia-smi name / power limit
  2. build       nvcc build of the four csrc/*.cu (histogram, split
                 scan, linear scan, walk), -Xptxas -v lines
  3. parity      every kernel mode against its plain version at the main
                 path's shapes (M=494,021, K=41, B=257, C=5; S=16 and the
                 widest chunk), CUDA-event times of kernel / plain / library;
                 the histogram also on the KDD99 twin's own bins with every
                 row in slot 0 (the root), plain and fused, and its float
                 path (float weights, moment rows) against the float64
                 plain sum, two launches bit for bit; the class-stacked
                 mode at a softmax round's shapes (5 lanes of moment rows
                 under float weights, 177,848 rows, S = 16 and 2,122; the
                 weights, slot_map and fused modes): each lane bit-equal
                 to a one-lane launch, two launches bit-equal, within 1e-5
                 of the float64 plain sum; the linear scan (the RG-LRU's
                 and the sLSTM's recurrence) forward and backward against
                 their plain loops bit for bit at phase train's sLSTM
                 [8, 128, 1536] and RG-LRU [8, 128, 2560] shapes and a
                 prefill's [2, 32768, 2560], two launches bit-equal, and
                 the gradients of a random loss through the op equal to
                 autograd through the per-position loop; the score walk
                 at a Higgs round's shape (one 511-node tree in 4,194,304
                 slots, 10.5M x 28 codes, 9 steps) and a softmax round's
                 (5 trees of 63 nodes, 444,619 x 41, 6 steps): labels
                 bit-equal to the plain walk, two launches bit-equal; the
                 histogram (plain, pairs) and the split scan (runtime-C
                 path) at the Covertype cell's shapes (M=522,911, K=54,
                 B=257, C=7, S=690), against their plain versions
  4. kdd99       the paper config on the synthetic KDD99-10% twin: kernel
                 build on the card, predict, and the same build on the CPU
                 (plain versions) must give the same tree
  5. wide        494,021 x 41 hybrid table with multi-chunk levels: the
                 subtraction-on tree equals the subtraction-off tree, and a
                 unit-weight build (weights mode) equals it too; one more
                 subtraction-off build under torch.profiler gives each
                 kernel's device time and the device's idle share
  toot           Training-Only-Once Tuning on the KDD99 twin: one full
                 tree (kernel histograms, torch selection), its dmax x 200
                 smin x 4 mcw design space priced on the card and on the
                 CPU (equal grids, fronts and best cell), the grid's
                 corners and 4 interior cells retrained on the card (zero
                 mismatches); configs priced per second
  gbt            logistic Newton boosting with GOSS (20 rounds, depth 6)
                 on the twin's normal-vs-attack target: two fits give the
                 same trees bit for bit, the n_rounds x dmax x smin x mcw
                 ensemble sweep equals refits at its corners and 2 interior
                 cells, holdout accuracy above the base rate; fit seconds
  softmax        softmax Newton boosting with GOSS (20 rounds, depth 6) on
                 the twin's 5 classes, each round's 5 class-trees through
                 one batched build: two fits bit-identical, round 0's
                 class-trees equal 5 card build_tree calls, holdout
                 accuracy above the base rate, one class-stacked histogram
                 launch per level chunk; fit seconds, peak memory
  forest         RandomForest (10 trees, 70 % of the features, depth 24):
                 votes equal a per-tree vote loop, two fits identical,
                 holdout accuracy > 0.9; fit seconds
  resume         the gbt fit stopped after round 7, a 6-round softmax fit
                 stopped after round 3 and the kdd99 build stopped after
                 level 4, each resumed from its checkpoint directory: equal
                 bit for bit to the uninterrupted run
  serve          forest serving: phase gbt's fit (t0) and a deeper
                 "dos vs rest" fit (t1, depth 8, fitted here through the
                 kernels) packed into a ModelRegistry(capacity=4) behind a
                 ForestServer with buckets 1/8/64/512, one CUDA graph per
                 (bucket, model-set shape): served outputs equal each
                 tenant's predict_proba_device bit for bit (whole holdout,
                 sizes 1/8/64, a mixed batch, an oversize request);
                 captures 4, then 0 on a second pass, 4 more after t1
                 grows the envelope, 0 after removing and re-adding t0, 0
                 after poisoning t1 (NonFiniteOutputError, breaker open, t0
                 bit-exact in the same flush); p50/p99 latency per bucket
                 against the eager walk, rows/s, request bytes, t1's fit
                 seconds, peak memory
  chaos          run_chaos(0) on the card: 14 faults, 0 unhandled, resume
                 parity 0.0, every outcome and the shed / served / retries
                 counts equal to BENCH_chaos.json (the reference's seed-0
                 run); with the breaker or the digest check off, at least
                 one fault unhandled
  dist           the sharded path (core.distributed) on a 1-rank NCCL
                 group, 1x1 ("data", "model") DeviceMesh: the phase-4
                 build under DistConfig(), slot_scatter=False and
                 model_axis=None equals phase 4's tree bit for bit, each
                 chunk's histogram collective hands in the bytes of the
                 reference's per-chunk arithmetic; build_batched on a
                 softmax round (5 classes, GOSS weights) within rtol/atol
                 1e-4 of build_trees_batched; the sharded boosting loop
                 (fit(mesh=, dist=)) on phase gbt's and phase softmax's
                 configs: two fits bit-identical, every round's selection
                 equal to goss_sample_sharded_ref's, predictions within
                 rtol/atol 1e-4 of the local loop fed the same draw,
                 holdout accuracy above the base rate, the logistic fit
                 stopped after round 7 and resumed bit for bit; phase
                 forest's config on the mesh gives its trees; phase 4's
                 tree swept on the mesh gives the local card grid;
                 collective calls / bytes by tag, sharded and local
                 seconds; kernel A's weights, slot_map and stacked modes
                 and kernel B launched, the fused epilogue not
  check          the contract gate (repro_torch.check) on the card: the
                 eleven contracts recorded under set_sync_debug_mode
                 ("error") must all hold; core/chunk-step, -kernel and
                 -batched again at full width (M=494,021, K=41, B=257, C=5
                 at S=16 and the widest chunk; 5 x 177,848 rows, C'=3);
                 every kernel launch's shared memory against the card's
                 opt-in limit; both seeded mutations (the grid's psum
                 through an all-gather, a .tolist() in the routed walk)
                 flip their contracts; seconds
  lm             the LM serving path (models/, serve.serve, launch.serve):
                 smollm-360m, recurrentgemma-2b and xlstm-125m at full width
                 through the launcher's own function (batch 4, prompt 16,
                 32 greedy tokens), tokens in range, prefill and the decode
                 loop again under set_sync_debug_mode("error") (cache index
                 48), decode against teacher-forced forward at T = 12
                 within 5e-2 with f32 activations (reported, not held,
                 at the configs' bf16); one JSON line a model (prefill / decode s, tok/s,
                 peak memory); the ten smoke archs in f32 on the card
                 against the port's own CPU result within 1e-3; the
                 launcher's --forest mode (3 tenants, 50 requests, p50 /
                 p99).  The RG-LRU and the sLSTM launch the linear scan
                 (forward)
  train          LM training (train/, launch.train, save_train_state /
                 restore_train_state): smollm-360m at full width through
                 the launcher's own function (batch 8, seq 128, lr 3e-4,
                 remat as configured; 8 steps, checkpoints every 4), a
                 fresh run resumed from step 4 equal to the straight run
                 bit for bit,
                 the loss falling over 8 steps on one fixed batch;
                 recurrentgemma-2b and xlstm-125m, 3 steps each (finite
                 loss and grad norm, every parameter moved); a step of
                 each under set_sync_debug_mode("error"); one JSON line a
                 model (step ms, tokens/s, device ops / busy ms / idle
                 share a step, peak memory, the step's bound, the port's
                 AdamW against torch.optim.AdamW(fused=True)); the ten
                 smoke archs' step in f32 on the card against the port's
                 own CPU step within 1e-4 (loss alone where an xLSTM
                 normaliser value lies on the other side of its kink at
                 |n| = 1 on the card); the launcher's --arch udt
                 --smoke.  The RG-LRU and the sLSTM launch the linear
                 scan forward and backward
  mesh           the sharded LM (models/sharding.py, placement.py, the
                 mesh paths, the sharded train step) on a 1-rank NCCL
                 group with a 1x1 ("data", "model") mesh, where every
                 collective has size 1: smollm-360m at full width through
                 the launchers' own functions, 32 greedy tokens (batch 4,
                 prompt 16) equal to phase lm's and the prefill's logits
                 equal to the no-mesh model's (max |diff| 0.0), 3 train
                 steps (batch 8, seq 128) bit-equal to a no-mesh run from
                 the same seed; decode ms a step and step ms beside the
                 no-mesh ones, collectives a step by tag, the device idle
                 share; xlstm-125m at full width, 3 train steps (batch 8,
                 seq 128) bit-equal to a no-mesh run from the same seed
                 (the sLSTM's local block: its gate columns by one
                 all-to-all, the linear scan on its channels), collectives
                 a step by tag; arctic-smoke's MoE block on the a2a and
                 local paths equal to the plain path
  dryrun         the dry-run analysis (launch/analysis, specs, dryrun):
                 (i) smollm-360m's four cells on 16x16 (long_500k a SKIP
                 row) and the UDT cell on 16x16 and 2x16x16, recorded on
                 fake CPU tensors (host work); (ii) smollm-360m's forward
                 and train step at batch 8, seq 128, no mesh, counted on
                 fake CPU tensors and for real on the card: FLOPs and
                 bytes equal as integers, real ms (CUDA events) at least
                 the analysis's bound, argument + temp bytes within 25 %
                 of the step's max_memory_allocated; xlstm-125m's train
                 step at the same shape, its FLOPs, bytes and ops equal
                 fake and real (the linear scan's operands counted alike
                 on both devices); (iii) the UDT level
                 chunk (m = 2^20 random rows, k = 48, C = 24, 256 slots)
                 with the kernel backends on a 1-rank NCCL group: both
                 kernels launch, the NCCL log equals a 1x1 recording's
                 call for call, the chunk's ms at least its bound.  One
                 dryrun JSON line a check
  6. kernels     one JSON line: every kernel, its launches on the main
                 paths (phases 4, 5, toot, gbt, softmax, forest, resume,
                 serve, chaos, dist, check, lm, train, mesh, dryrun),
                 parity and times
The last line is ``{"ok": true, "device": {...}}``.  Imports torch, numpy
and repro_torch only.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

M_ROWS = 494021          # KDD99-10% rows (the paper's headline dataset)
N_FEAT = 41
N_CLASS = 5
# rows of a boosting round on the twin's 90 % split: GOSS(0.2, 0.2) of
# 444,619 training rows
SOFTMAX_ROWS = 177848
# the Covertype cell's training rows, features and classes: C = 7 takes
# kernel B's runtime-C instantiation (split_scan.cu compiles C = 2, 3, 5)
COVER_ROWS = 522911
COVER_FEAT = 54
COVER_CLASS = 7
# H100 SXM data-sheet peaks (the bound_ms columns use them)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the __global__ functions of src/repro_torch/csrc (phase 5's and phase
# train's profiles)
KERNEL_FUNCTIONS = ("count_kernel", "plan_kernel", "scatter_kernel",
                    "tile_kernel", "merge_kernel", "split_scan_kernel",
                    "linear_scan_walk_kernel", "linear_scan_staged_kernel",
                    "linear_scan_backward_walk_kernel",
                    "linear_scan_backward_staged_kernel", "walk_kernel")
TREE_FIELDS_EXACT = ("feat", "op", "tbin", "label", "count", "depth", "left",
                     "right", "leaf", "parent")


class SmokeFailure(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    need(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2):
    """Mean time of ``fn`` on the card (CUDA events, after a warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_function(name: str) -> str:
    """A profiler event's kernel name without namespace, template arguments
    and parameters (``tile_kernel`` of ``void (anonymous
    namespace)::tile_kernel<true, false>(...)``)."""
    return name.split("(anonymous namespace)::", 1)[-1].split("(")[0] \
        .split("<")[0]


def device_ms(fn, kernels, reps=10, warmup=2, tries=3):
    """Mean device time of one launch of the csrc kernels named in
    ``kernels`` while ``fn`` runs ``reps`` times: torch.profiler's kernel
    spans, so no host time between launches counts.  Each call of ``fn``
    launches one of them.  The profiler drops spans now and then (7 of 10
    once, all 20 of a session once), so the mean is over those it kept,
    at least half, and a session that kept fewer is run again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [ev.time_range.end - ev.time_range.start
                 for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA
                 and kernel_function(ev.name) in kernels]
        if reps / 2 <= len(spans) <= reps:
            return sum(spans) / len(spans) / 1e3
    need(False, f"profiler saw {len(spans)} launches of {kernels}, expected "
                f"{reps}, {tries} times")


def bound(nbytes, nops):
    """(least ms on the card, what bounds it) from data-sheet peaks."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# phase 3: every kernel mode against its plain version
# ---------------------------------------------------------------------------

def _hist_inputs(s, mode, integer_weights, dev, seed, m=None, k=None,
                 c=None):
    """Main-path-shaped histogram inputs, made on the card from a seed;
    ``m`` rows of ``k`` features and ``c`` classes (default: the KDD99
    twin's), ``s`` raw slots (the level loop's chunk width); slot_map,
    fused and pairs pack them into s // 2 pairs (pairs: the launch picks
    the children)."""
    import torch
    m, k, c = m or M_ROWS, k or N_FEAT, c or N_CLASS
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    bins = ints(0, 257, (m, k))
    stats = torch.eye(c, device=dev)[ints(0, c, (m,)).long()]
    slot = ints(-1, s, (m,))
    kw = dict(num_slots=s, n_bins=257)
    if mode == "weights":
        kw["weights"] = (ints(1, 4, (m,)).float() if integer_weights
                         else torch.rand((m,), generator=g, device=dev)
                         + 0.5)
    if mode in ("slot_map", "fused", "pairs"):
        p = s // 2
        side = ints(0, 2, (p,)).long()
        compute = torch.zeros(s, dtype=torch.bool, device=dev)
        compute[2 * torch.arange(p, device=dev) + side] = True
        kw["slot_map"] = torch.where(
            compute, torch.arange(s, device=dev) // 2, -1).to(torch.int32)
        kw["num_slots"] = p
    if mode in ("fused", "pairs"):
        kw["phist"] = ints(0, 9, (p, k, 257, c)).float()
        kw["side"] = (1 - side).to(torch.int32)
    if mode == "pairs":
        del kw["slot_map"], kw["side"]
    return bins, stats, slot, kw


def _with_explicit_mask(slot, kw):
    """A pairs call's inputs as a fused call given the children the launch
    picks (``smaller_child_mask``'s mask of every lane), which it must
    equal bit for bit; other calls as they are."""
    import torch
    from repro_torch.core.histogram import smaller_child_mask
    if kw.get("phist") is None or kw.get("side") is not None:
        return kw
    compute = smaller_child_mask(slot, 2 * kw["num_slots"])
    ids = torch.arange(compute.shape[-1], device=slot.device)
    return dict(kw, side=compute[..., 0::2].to(torch.int32),
                slot_map=torch.where(compute, ids // 2, -1).to(torch.int32))


def _hist_cost(bins, stats, slot, kw):
    """Bytes and operations this call's data needs: every slot read, the
    bins / stats (/ weight) of the rows that land in the output, the
    optional tables, every output written once."""
    from repro_torch.kernels.histogram import remap_slots
    kw = _with_explicit_mask(slot, kw)
    sl = slot if kw.get("slot_map") is None else remap_slots(slot, kw["slot_map"])
    active = int(((sl >= 0) & (sl < kw["num_slots"])).sum())
    k, b, c = bins.shape[1], kw["n_bins"], stats.shape[1]
    out = kw["num_slots"] * k * b * c
    nbytes = slot.numel() * 4 + active * (k + c) * 4 + out * 4
    nops = active * k * c
    if kw.get("weights") is not None:
        nbytes += active * 4
        nops += active * k * c
    if kw.get("slot_map") is not None:
        nbytes += kw["slot_map"].numel() * 4
    if kw.get("phist") is not None:
        nbytes += out * 4 + kw["side"].numel() * 4 + out * 4   # read + 2x write
        nops += out
    return nbytes, nops


def _library_ms(bins, stats, slot, kw):
    """Time of one ``index_add_`` computing the same histogram over a
    prepared flat index, with the rows remapped (slot_map) and pre-weighted
    (weights) beforehand; the fused mode has no single-call counterpart."""
    import torch
    from repro_torch.kernels.histogram import remap_slots
    sl = slot if kw.get("slot_map") is None else remap_slots(slot, kw["slot_map"])
    s, k, b = kw["num_slots"], bins.shape[1], kw["n_bins"]
    keep = ((sl >= 0) & (sl < s)).nonzero()[:, 0]
    idx = ((sl[keep].long()[:, None] * k
            + torch.arange(k, device=bins.device)) * b
           + bins[keep].long()).reshape(-1)
    rows = stats[keep]
    if kw.get("weights") is not None:
        rows = rows * kw["weights"][keep, None]
    src = rows[:, None, :].expand(-1, k, -1).reshape(-1, rows.shape[1]).contiguous()
    h = torch.zeros((s * k * b, rows.shape[1]), device=bins.device)
    return cuda_ms(lambda: h.index_add_(0, idx, src))


def _float_inputs(s, mode, kind, dev, seed):
    """The float path at a boosting round's shapes: class rows (C = 5) under
    float weights ("float_w"), or (1, z, z^2) moment rows (C = 3) under
    float weights ("moments"), the inputs of ``_hist_inputs`` otherwise."""
    import torch
    bins, stats, slot, kw = _hist_inputs(s, mode, True, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    kw["weights"] = torch.rand((M_ROWS,), generator=g, device=dev) + 0.5
    if kind == "moments":
        z = 2.0 * torch.randn((M_ROWS,), generator=g, device=dev)
        stats = torch.stack([torch.ones_like(z), z, z * z], dim=1)
        if "phist" in kw:
            kw["phist"] = kw["phist"][..., :3].contiguous()
    return bins, stats, slot, kw


def _plain64(bins, stats, slot, kw):
    """The plain version summed in float64: the truth the float path is
    held to (the float32 plain version rounds each of its adds)."""
    from repro_torch.kernels.histogram import histogram_plain
    kw64 = {k: v.double() if k in ("weights", "phist") else v
            for k, v in kw.items()}
    return histogram_plain(bins, stats.double(), slot, **kw64)


def _root_inputs(table, y, mode, dev):
    """The KDD99 twin's own binned table with every row in slot 0 of a
    16-slot chunk (the root level); fused packs the 16 raw slots into 8
    pairs with slot 0 the computed child of pair 0."""
    import torch
    bins = torch.as_tensor(table.bins, device=dev)
    stats = torch.eye(N_CLASS, device=dev)[torch.as_tensor(y, device=dev).long()]
    slot = torch.zeros(bins.shape[0], dtype=torch.int32, device=dev)
    kw = dict(num_slots=16, n_bins=int(table.n_bins))
    if mode == "fused":
        from repro_torch.kernels.histogram import histogram_plain
        full = histogram_plain(bins, stats, slot, **kw)
        kw["slot_map"] = torch.full((16,), -1, dtype=torch.int32, device=dev)
        kw["slot_map"][0] = 0
        kw["num_slots"] = 8
        kw["phist"] = full[:8].contiguous()
        kw["side"] = torch.ones(8, dtype=torch.int32, device=dev)
    return bins, stats, slot, kw


# flops per scored candidate (logf counted as one), by heuristic, for C
# channels: the formulas of core/heuristics.py plus the pos/neg/count sums
_SCAN_OPS = {"info_gain": lambda c: 12 * c + 6, "gini": lambda c: 8 * c + 5,
             "chi_square": lambda c: 16 * c + 3, "sse": lambda c: 4 * c + 7}


def _scan_cost(hist, heuristic):
    s, k, b, c = hist.shape
    nbytes = hist.numel() * 4 + 2 * k * 4 + s * k * 12
    nops = s * k * b * (3 * c + 3 * _SCAN_OPS[heuristic](c))
    return nbytes, nops


def _scan_parity(hist, n_num, n_cat, heur, what):
    """Kernel B against its plain version on ``hist``: scores within
    rtol/atol 1e-5, the same bin and op on every unique best; the line's
    error, ties, kernel / plain ms and bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.split_scan import split_scan_cuda, split_scan_plain
    args = dict(heuristic=heur, min_leaf=1)
    s1, b1, o1 = split_scan_cuda(hist, n_num, n_cat, **args)
    s0, b0, o0 = split_scan_plain(hist, n_num, n_cat, **args)
    torch.cuda.synchronize()
    err = float((s1 - s0).abs().max())
    need(torch.allclose(s1, s0, rtol=1e-5, atol=1e-5),
         f"split_scan {heur} {what}: score mismatch (max abs {err})")
    unique = ref.best_is_unique(hist, n_num, n_cat, **args)
    need(torch.equal(b1[unique], b0[unique])
         and torch.equal(o1[unique], o0[unique]),
         f"split_scan {heur} {what}: bin/op differ on a unique best")
    line = dict(heuristic=heur, max_abs_err=err,
                non_unique=int((~unique).sum()),
                ms=cuda_ms(lambda: split_scan_cuda(hist, n_num, n_cat,
                                                   **args)),
                plain_ms=cuda_ms(lambda: split_scan_plain(
                    hist, n_num, n_cat, **args), reps=3, warmup=1))
    line["bound_ms"], line["bound_by"] = bound(*_scan_cost(hist, heur))
    return line


def phase_parity(dev, widest, kdd):
    import torch
    from repro_torch.kernels.histogram import histogram_cuda, histogram_plain

    rows = {}
    failures = []
    for s in (16, widest):
        for mode in ("plain", "weights", "slot_map", "fused", "pairs"):
            for integer_weights in ((True, False) if mode == "weights"
                                    else (True,)):
                bins, stats, slot, kw = _hist_inputs(s, mode, integer_weights,
                                                     dev, seed=s)
                got = histogram_cuda(bins, stats, slot, **kw)
                want = histogram_plain(bins, stats, slot, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if mode == "pairs":
                    need(torch.equal(got, histogram_cuda(
                        bins, stats, slot, **_with_explicit_mask(slot, kw))),
                         f"histogram pairs S={s}: != the fused launch "
                         "given the mask")
                if integer_weights:
                    ok = torch.equal(got, want)
                    rule = "exact"
                else:
                    ok = torch.allclose(got, want, rtol=1e-5, atol=0)
                    rule = "rtol 1e-5"
                need(ok, f"histogram {mode} S={s}: kernel != plain "
                         f"(max abs err {err})")
                tag = f"{mode}{'' if integer_weights else ' (float w)'}"
                line = dict(S=s, mode=tag, rule=rule, max_abs_err=err)
                if integer_weights:
                    line["ms"] = cuda_ms(lambda: histogram_cuda(bins, stats,
                                                                slot, **kw))
                    line["plain_ms"] = cuda_ms(lambda: histogram_plain(
                        bins, stats, slot, **kw), reps=3, warmup=1)
                    line["bound_ms"], line["bound_by"] = bound(
                        *_hist_cost(bins, stats, slot, kw))
                    line["library_ms"] = (
                        None if mode in ("fused", "pairs") else
                        _library_ms(bins, stats, slot, kw))
                say("  histogram", json.dumps(line))
                rows[("histogram", mode, s, integer_weights)] = line
                del bins, stats, slot, kw, got, want
                torch.cuda.empty_cache()

        # the float path at a boosting round's shapes (weights: a round's
        # root; fused and pairs: its later levels): within rtol/atol 1e-5
        # of the float64 plain sum, and two launches equal bit for bit
        # (pairs: also to the fused launch given the mask).  A failed check
        # is collected and raised after the loop, so every time is printed
        # (a parent commit's float path is not deterministic).
        for mode in ("weights", "fused", "pairs"):
            for kind in ("float_w", "moments"):
                bins, stats, slot, kw = _float_inputs(s, mode, kind, dev,
                                                      seed=s + 2)
                got = histogram_cuda(bins, stats, slot, **kw)
                again = histogram_cuda(bins, stats, slot, **kw)
                torch.cuda.synchronize()
                if mode == "pairs":
                    again = histogram_cuda(bins, stats, slot,
                                           **_with_explicit_mask(slot, kw))
                line = dict(S=s, mode=mode, kind=kind,
                            rule="rtol/atol 1e-5 vs float64 plain; "
                                 "two launches bit-equal",
                            differing_cells=int((got != again).sum()))
                try:
                    want = _plain64(bins, stats, slot, kw)
                    line["max_abs_err"] = float((got.double() - want).abs().max())
                    ok = torch.allclose(got.double(), want, rtol=1e-5,
                                        atol=1e-5)
                    del want
                except RuntimeError as e:        # no float64 plain version
                    line["max_abs_err"], ok = None, False
                    line["error"] = str(e).splitlines()[0]
                if not ok:
                    failures.append(f"histogram {mode} {kind} S={s}: kernel "
                                    f"!= float64 plain ({line})")
                if line["differing_cells"]:
                    failures.append(f"histogram {mode} {kind} S={s}: two "
                                    f"launches differ in "
                                    f"{line['differing_cells']} cells")
                line["ms"] = cuda_ms(lambda: histogram_cuda(bins, stats, slot,
                                                            **kw))
                line["plain_ms"] = cuda_ms(lambda: histogram_plain(
                    bins, stats, slot, **kw), reps=3, warmup=1)
                line["bound_ms"], line["bound_by"] = bound(
                    *_hist_cost(bins, stats, slot, kw))
                line["library_ms"] = (None if mode in ("fused", "pairs") else
                                      _library_ms(bins, stats, slot, kw))
                say("  histogram float path", json.dumps(line))
                rows[("histogram_float", mode, kind, s)] = line
                del bins, stats, slot, kw, got, again
                torch.cuda.empty_cache()

        if s == 16:
            # real bins at the root: every row of the KDD99 twin in slot 0
            for mode in ("plain", "fused"):
                bins, stats, slot, kw = _root_inputs(*kdd, mode, dev)
                got = histogram_cuda(bins, stats, slot, **kw)
                want = histogram_plain(bins, stats, slot, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                need(torch.equal(got, want),
                     f"histogram {mode} on the KDD99 root: kernel != plain "
                     f"(max abs err {err})")
                line = dict(S=16, mode=mode, bins="kdd99 root", rule="exact",
                            max_abs_err=err,
                            ms=cuda_ms(lambda: histogram_cuda(bins, stats,
                                                              slot, **kw)),
                            plain_ms=cuda_ms(lambda: histogram_plain(
                                bins, stats, slot, **kw), reps=3, warmup=1))
                line["bound_ms"], line["bound_by"] = bound(
                    *_hist_cost(bins, stats, slot, kw))
                say("  histogram", json.dumps(line))
                rows[("histogram_root", mode)] = line
                del bins, stats, slot, kw, got, want
                torch.cuda.empty_cache()

        # split scan on the kernel's own histogram of class rows, and on
        # moment rows (C = 3) for sse
        g = torch.Generator(device=dev).manual_seed(7)
        n_num = torch.randint(1, 250, (N_FEAT,), generator=g, device=dev,
                              dtype=torch.int32)
        n_cat = torch.minimum(torch.randint(0, 6, (N_FEAT,), generator=g,
                                            device=dev, dtype=torch.int32),
                              256 - n_num)
        bins, stats, slot, kw = _hist_inputs(s, "plain", True, dev, seed=s + 1)
        bins = torch.minimum(bins, (n_num + n_cat)[None, :])   # missing bin max
        h_cls = histogram_cuda(bins, stats, slot, **kw)
        y = torch.randn((M_ROWS,), generator=g, device=dev)
        h_mom = histogram_cuda(bins, torch.stack([torch.ones_like(y), y, y * y],
                                                 dim=1), slot, **kw)
        del bins, stats, slot
        for heur in ("info_gain", "gini", "chi_square", "sse"):
            hist = h_mom if heur == "sse" else h_cls
            line = dict(S=s, **_scan_parity(hist, n_num, n_cat, heur,
                                            f"S={s}"), library_ms=None)
            say("  split_scan", json.dumps(line))
            rows[("split_scan", heur, s)] = line
        del h_cls, h_mom
        torch.cuda.empty_cache()
    need(not failures, "; ".join(failures))
    return rows


def phase_wide_class(dev):
    """Kernels A and B at the Covertype cell's shapes: M = 522,911 rows,
    K = 54, B = 257, C = 7 class rows, S = 690 slots (the level loop's
    chunk cap at that width).  The histogram's plain and pairs modes (a level the
    cache misses, a level below a cached one) bit-equal to the plain sum;
    the split scan (runtime-C path) on that histogram within rtol/atol
    1e-5 of its plain version, equal bin and op on every unique best."""
    import torch
    from repro_torch.core.tree import _auto_chunk_slots
    from repro_torch.kernels.histogram import histogram_cuda, histogram_plain

    m, k, c = COVER_ROWS, COVER_FEAT, COVER_CLASS
    s = _auto_chunk_slots(k, 257, c, 1 << 28)
    s -= s % 2                                 # the level loop's even chunk
    shape = dict(M=m, K=k, B=257, C=c, S=s)
    # the cell's columns as binned: 10 numeric of up to 256 bins, then the
    # 44 one-hot columns of 2, no categorical column; a share of missing
    # codes (bin n_num) so that the ops' scores differ and best bins and
    # ops are compared
    g = torch.Generator(device=dev).manual_seed(11)
    n_num = torch.full((k,), 2, dtype=torch.int32, device=dev)
    n_num[:10] = torch.randint(2, 257, (10,), generator=g, device=dev,
                               dtype=torch.int32)
    n_cat = torch.zeros(k, dtype=torch.int32, device=dev)
    rows = {}
    for mode in ("plain", "pairs"):
        bins, stats, slot, kw = _hist_inputs(s, mode, True, dev, seed=s + 3,
                                             m=m, k=k, c=c)
        bins = torch.remainder(bins, n_num[None, :] + 1)
        got = histogram_cuda(bins, stats, slot, **kw)
        want = histogram_plain(bins, stats, slot, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        need(torch.equal(got, want), f"histogram {mode} C={c} S={s}: kernel "
                                     f"!= plain (max abs err {err})")
        line = dict(shape, mode=mode, rule="exact", max_abs_err=err,
                    ms=cuda_ms(lambda: histogram_cuda(bins, stats, slot,
                                                      **kw)),
                    plain_ms=cuda_ms(lambda: histogram_plain(
                        bins, stats, slot, **kw), reps=3, warmup=1))
        line["bound_ms"], line["bound_by"] = bound(
            *_hist_cost(bins, stats, slot, kw))
        say("  histogram wide class", json.dumps(line))
        rows[("histogram", mode)] = line
        if mode == "plain":
            h_cls = got
        del bins, stats, slot, kw, got, want
        torch.cuda.empty_cache()

    for heur in ("info_gain", "gini", "chi_square"):
        line = dict(shape, **_scan_parity(h_cls, n_num, n_cat, heur,
                                          f"C={c} S={s}"))
        say("  split_scan wide class", json.dumps(line))
        rows[("split_scan", heur)] = line
        torch.cuda.empty_cache()
    return rows


def _stacked_inputs(s, mode, dev, seed):
    """A softmax round's class-stacked histogram inputs, made on the card:
    ``N_CLASS`` lanes of (1, z, z^2) moment rows under float hessian-style
    weights (GOSS amplification 4 x p(1 - p) on the sampled remainder) over
    the round's 177,848 GOSS rows of one shared bins table; slot_map (the
    sharded batched build's smaller child) and fused pack the ``s`` raw
    slots of every lane into ``s // 2`` pairs."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    m, lanes = SOFTMAX_ROWS, N_CLASS
    bins = torch.randint(0, 257, (m, N_FEAT), generator=g, device=dev,
                         dtype=torch.int32)
    z = 3.0 * torch.randn((lanes, m), generator=g, device=dev)
    stats = torch.stack([torch.ones_like(z), z, z * z], dim=-1).contiguous()
    p = torch.rand((lanes, m), generator=g, device=dev)
    amp = torch.where(torch.rand((m,), generator=g, device=dev) < 0.5, 1.0,
                      4.0)
    kw = dict(num_slots=s, n_bins=257,
              weights=(amp[None] * p * (1 - p)).clamp(min=1e-6).contiguous())
    slot = torch.randint(-1, s, (lanes, m), generator=g, device=dev,
                         dtype=torch.int32)
    if mode in ("slot_map", "fused", "pairs"):
        q = s // 2
        side = torch.randint(0, 2, (lanes, q), generator=g, device=dev)
        compute = torch.zeros((lanes, s), dtype=torch.bool, device=dev)
        compute.scatter_(1, 2 * torch.arange(q, device=dev)[None] + side, True)
        kw["slot_map"] = torch.where(compute, torch.arange(s, device=dev) // 2,
                                     -1).to(torch.int32)
        kw["num_slots"] = q
    if mode in ("fused", "pairs"):
        kw["phist"] = 50.0 * torch.rand((lanes, q, N_FEAT, 257, 3),
                                        generator=g, device=dev)
        kw["side"] = (1 - side).to(torch.int32)
    if mode == "pairs":
        del kw["slot_map"], kw["side"]
    return bins, stats, slot, kw


def _stacked_cost(bins, stats, slot, kw):
    """Bytes and operations of one class-stacked call: every lane's slots
    read, the shared bins once, each landing row's stats and weight, the
    optional tables, every output cell written once."""
    import torch
    from repro_torch.kernels.histogram import remap_slots
    lanes, m, c = stats.shape
    kw = _with_explicit_mask(slot, kw)
    if kw.get("slot_map") is not None:
        sl = torch.stack([remap_slots(slot[i], kw["slot_map"][i])
                          for i in range(lanes)])
    else:
        sl = slot
    active = int(((sl >= 0) & (sl < kw["num_slots"])).sum())
    k, b = bins.shape[1], kw["n_bins"]
    out = lanes * kw["num_slots"] * k * b * c
    nbytes = (slot.numel() * 4 + bins.numel() * 4 + active * (c + 1) * 4
              + out * 4)
    nops = 2 * active * k * c
    if kw.get("slot_map") is not None:
        nbytes += kw["slot_map"].numel() * 4
    if kw.get("phist") is not None:
        nbytes += out * 4 + kw["side"].numel() * 4 + out * 4   # read + 2x write
        nops += out
    return nbytes, nops


def _stacked_library_ms(bins, stats, slot, kw):
    """One ``index_add_`` over the folded flat index (lane, slot, feature,
    bin), with each lane's slots remapped (slot_map) and the rows
    pre-weighted (weights) beforehand: the same histogram as the weights
    and slot_map modes in one PyTorch call."""
    import torch
    from repro_torch.kernels.histogram import remap_slots
    lanes, m, c = stats.shape
    s, k, b = kw["num_slots"], bins.shape[1], kw["n_bins"]
    if kw.get("slot_map") is not None:
        slot = torch.stack([remap_slots(slot[i], kw["slot_map"][i])
                            for i in range(lanes)])
    keep = ((slot >= 0) & (slot < s)).nonzero()
    lane, row = keep[:, 0], keep[:, 1]
    idx = ((((lane * s + slot[lane, row].long())[:, None] * k)
            + torch.arange(k, device=bins.device)) * b
           + bins[row].long()).reshape(-1)
    rows = stats[lane, row]
    if kw.get("weights") is not None:
        rows = rows * kw["weights"][lane, row][:, None]
    src = rows[:, None, :].expand(-1, k, -1).reshape(-1, c).contiguous()
    h = torch.zeros((lanes * s * k * b, c), device=bins.device)
    return cuda_ms(lambda: h.index_add_(0, idx, src))


def phase_stacked(dev, widest):
    """Kernel A's class-stacked mode at a softmax round's shapes, in the
    weights (the root), fused and pairs (later levels; pairs picks the
    children in the launch) and slot_map (later levels of the sharded
    batched build) modes: within rtol/atol 1e-5 of the float64 plain sum,
    each lane bit-equal to a one-lane launch on its inputs, two launches
    bit-equal (pairs: also to the fused launch given the mask); times of
    the kernel, its plain version (a loop over lanes) and the folded
    ``index_add_`` (none for fused and pairs, which have no single-call
    counterpart)."""
    import torch
    from repro_torch.kernels.histogram import (histogram_cuda,
                                               histogram_stacked_cuda,
                                               histogram_stacked_plain)
    rows = {}
    failures = []
    for s in (16, widest):
        for mode in ("weights", "slot_map", "fused", "pairs"):
            bins, stats, slot, kw = _stacked_inputs(s, mode, dev, seed=s + 5)
            got = histogram_stacked_cuda(bins, stats, slot, **kw)
            again = histogram_stacked_cuda(bins, stats, slot,
                                           **_with_explicit_mask(slot, kw))
            lane_diff = []
            for i in range(N_CLASS):
                one = histogram_cuda(bins, stats[i], slot[i],
                                     **{k: (v[i] if isinstance(v, torch.Tensor)
                                            else v) for k, v in kw.items()})
                lane_diff.append(int((got[i] != one).sum()))
                del one
            torch.cuda.synchronize()
            kw64 = {k: v.double() if k in ("weights", "phist") else v
                    for k, v in kw.items()}
            want = histogram_stacked_plain(bins, stats.double(), slot, **kw64)
            err = float((got.double() - want).abs().max())
            ok = torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5)
            del want
            line = dict(S=s, lanes=N_CLASS, rows=int(bins.shape[0]),
                        mode=mode, kind="moments, float weights",
                        rule="rtol/atol 1e-5 vs float64 plain; each lane "
                             "bit-equal to a one-lane launch; two launches "
                             "bit-equal",
                        max_abs_err=err, lane_differing_cells=lane_diff,
                        differing_cells=int((got != again).sum()))
            if not ok:
                failures.append(f"stacked {mode} S={s}: kernel != float64 "
                                f"plain (max abs err {err})")
            if any(lane_diff):
                failures.append(f"stacked {mode} S={s}: lanes differ from "
                                f"one-lane launches in {lane_diff} cells")
            if line["differing_cells"]:
                failures.append(f"stacked {mode} S={s}: two launches differ")
            line["ms"] = cuda_ms(lambda: histogram_stacked_cuda(
                bins, stats, slot, **kw))
            line["plain_ms"] = cuda_ms(lambda: histogram_stacked_plain(
                bins, stats, slot, **kw), reps=3, warmup=1)
            line["bound_ms"], line["bound_by"] = bound(
                *_stacked_cost(bins, stats, slot, kw))
            line["library_ms"] = (None if mode in ("fused", "pairs") else
                                  _stacked_library_ms(bins, stats, slot, kw))
            say("  histogram stacked", json.dumps(line))
            rows[(mode, s)] = line
            del bins, stats, slot, kw, got, again
            torch.cuda.empty_cache()
    need(not failures, "; ".join(failures))
    return rows


# ---------------------------------------------------------------------------
# phase 3: the linear scan against its plain loops
# ---------------------------------------------------------------------------

# the linear scan's shapes: phase train's sLSTM (xlstm-125m, d_i = 1,536)
# and RG-LRU (recurrentgemma-2b, 2,560) at batch 8, seq 128, a prefill at
# 32k positions, and phase lm's decode step (batch 4, one position)
SCAN_SHAPES = ((8, 128, 1536), (8, 128, 2560), (2, 32768, 2560),
               (4, 1, 2560))
# the short-T threshold's sweep: both paths at [4, T, 2560]
SCAN_SWEEP_T = (1, 2, 4, 6, 8, 12, 16, 24, 32, 64, 128)


def _scan_kernels(plan, backward):
    return ("linear_scan_backward_" if backward else "linear_scan_") + \
        ("staged_kernel" if plan.staged else "walk_kernel")


def _scan_operands(shape, dev):
    import torch
    bsz, t, d = shape
    g = torch.Generator(device=dev).manual_seed(t + d)
    a = torch.rand(shape, generator=g, device=dev) * 0.95 + 0.049
    return (a, torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev), g)


def _scan_sweep(dev):
    """Both launch paths (the short walk, the staged walk) at [4, T, 2560]
    for T in SCAN_SWEEP_T: device ms a launch each way, both bit-equal to
    the plain loops; the plan's pick beside the faster path (the short-T
    thresholds of ``kernels/linear_scan.py`` come from this sweep)."""
    import torch
    from repro_torch.kernels.linear_scan import (
        linear_scan_backward_cuda, linear_scan_backward_plain,
        linear_scan_cuda, linear_scan_plain, scan_plan)
    rows = []
    for t in SCAN_SWEEP_T:
        shape = (4, t, 2560)
        a, b, gy, _ = _scan_operands(shape, dev)
        h_p = linear_scan_plain(a, b)
        da_p, db_p = linear_scan_backward_plain(a, h_p, gy)
        row = dict(shape=list(shape), plan={
            k: "staged" if scan_plan(shape, backward=k == "backward").staged
            else "walk" for k in ("forward", "backward")})
        for path, short_t in (("walk", t + 1), ("staged", 0)):
            pf = scan_plan(shape, short_t=short_t)
            pb = scan_plan(shape, backward=True, short_t=short_t)
            h = linear_scan_cuda(a, b, pf)
            da, db = linear_scan_backward_cuda(a, h, gy, pb)
            torch.cuda.synchronize()
            need(torch.equal(h, h_p) and torch.equal(da, da_p)
                 and torch.equal(db, db_p),
                 f"linear scan {path} path != plain at {shape}")
            row[f"{path}_device_ms"] = dict(
                forward=device_ms(lambda: linear_scan_cuda(a, b, pf),
                                  (_scan_kernels(pf, False),), reps=20),
                backward=device_ms(
                    lambda: linear_scan_backward_cuda(a, h, gy, pb),
                    (_scan_kernels(pb, True),), reps=20))
        row["bit_equal"] = True
        row["faster"] = {
            k: min(("walk", "staged"),
                   key=lambda p_: row[f"{p_}_device_ms"][k])
            for k in ("forward", "backward")}
        say("  linear_scan paths", json.dumps(row))
        rows.append(row)
    return rows


def _host_us(fn, reps=50):
    """Mean host time of one call of ``fn`` (no sync between calls; the
    card drains the queue after)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def phase_linear_scan(dev):
    """The linear scan forward and backward against their plain loops, bit
    for bit, at SCAN_SHAPES: two launches bit-equal, the kernel's
    CUDA-event ms (10 back-to-back wrapper calls: host issue included),
    device ms (the profiler's kernel spans) and a wrapper call's host us,
    the plain loop's ms, the bound (bytes: 3 B T D 4 forward, 5 B T D 4
    backward) and the bound's share of the device time; no single PyTorch
    call computes the recurrence (a cumprod / cumsum form divides by a
    vanishing product), so no library time.  At T <= 128, the gradients of
    a random loss through the op equal autograd through the per-position
    loop.  Then both launch paths across the short-T thresholds
    (``_scan_sweep``)."""
    import torch
    from repro_torch.kernels.linear_scan import (
        linear_scan, linear_scan_backward_cuda, linear_scan_backward_plain,
        linear_scan_cuda, linear_scan_plain, scan_plan)
    from repro_torch.kernels.ref import linear_scan_loop
    rows = {}
    for shape in SCAN_SHAPES:
        bsz, t, d = shape
        a, b, gy, g = _scan_operands(shape, dev)
        n = bsz * t * d
        h = linear_scan_cuda(a, b)
        h_plain = linear_scan_plain(a, b)
        again = linear_scan_cuda(a, b)
        da, db = linear_scan_backward_cuda(a, h, gy)
        da_p, db_p = linear_scan_backward_plain(a, h_plain, gy)
        da2, db2 = linear_scan_backward_cuda(a, h, gy)
        torch.cuda.synchronize()
        fwd = dict(shape=list(shape), direction="forward",
                   rule="bit for bit", bit_equal=bool(torch.equal(h, h_plain)),
                   two_launches_equal=bool(torch.equal(h, again)),
                   max_abs_err=float((h - h_plain).abs().max()))
        bwd = dict(shape=list(shape), direction="backward",
                   rule="bit for bit",
                   bit_equal=bool(torch.equal(da, da_p)
                                  and torch.equal(db, db_p)),
                   two_launches_equal=bool(torch.equal(da, da2)
                                           and torch.equal(db, db2)),
                   max_abs_err=max(float((da - da_p).abs().max()),
                                   float((db - db_p).abs().max())))
        del h_plain, again, da_p, db_p, da2, db2
        for line, backward in ((fwd, False), (bwd, True)):
            plan = scan_plan(shape, backward=backward)
            line["plan"] = dict(staged=plan.staged, grid=plan.grid,
                                stages=plan.stages, smem=plan.smem)
            line["kernel"] = _scan_kernels(plan, backward)
        fwd["host_us"] = _host_us(lambda: linear_scan_cuda(a, b))
        bwd["host_us"] = _host_us(lambda: linear_scan_backward_cuda(a, h, gy))
        fwd["ms"] = cuda_ms(lambda: linear_scan_cuda(a, b))
        fwd["device_ms"] = device_ms(lambda: linear_scan_cuda(a, b),
                                     (fwd["kernel"],))
        fwd["plain_ms"] = cuda_ms(lambda: linear_scan_plain(a, b), reps=1,
                                  warmup=0)
        bwd["ms"] = cuda_ms(lambda: linear_scan_backward_cuda(a, h, gy))
        bwd["device_ms"] = device_ms(
            lambda: linear_scan_backward_cuda(a, h, gy), (bwd["kernel"],))
        bwd["plain_ms"] = cuda_ms(
            lambda: linear_scan_backward_plain(a, h, gy), reps=1, warmup=0)
        fwd["bound_ms"], fwd["bound_by"] = bound(3 * n * 4, 2 * n)
        bwd["bound_ms"], bwd["bound_by"] = bound(5 * n * 4, 3 * n)
        for line in (fwd, bwd):
            line["share_of_bound"] = line["bound_ms"] / line["device_ms"]
            line["library_ms"] = None
            line["library"] = "none: no single PyTorch call"
        if t <= 128:
            w = torch.randn(shape, generator=g, device=dev)
            leaves = (a.clone().requires_grad_(), b.clone().requires_grad_())
            got = torch.autograd.grad((linear_scan(*leaves) * w).sum(),
                                      leaves)
            want = torch.autograd.grad(
                (linear_scan_loop(*leaves) * w).sum(), leaves)
            bwd["grads_equal_loop_autograd"] = all(
                torch.equal(x, y) for x, y in zip(got, want))
            del leaves, got, want, w
        for line in (fwd, bwd):
            say("  linear_scan", json.dumps(line))
        rows[("linear_scan", shape)] = fwd
        rows[("linear_scan_backward", shape)] = bwd
        del a, b, gy, h, da, db
        torch.cuda.empty_cache()
    bad = [f"{k[0]} {list(k[1])}: {v}" for k, v in rows.items()
           if not (v["bit_equal"] and v["two_launches_equal"]
                   and v.get("grads_equal_loop_autograd", True))]
    need(not bad, f"linear scan: kernel != plain: {bad}")
    _scan_sweep(dev)
    return rows


# (name, trees, rows, features, steps, nodes, node slots): a Higgs GOSS
# round's update (one depth-9 tree in the build's 4,194,304 slots) and a
# softmax round's (5 depth-6 class-trees in 2 * 444,619 + 1 slots)
WALK_SHAPES = (("higgs", 1, 10_500_000, 28, 9, 511, 1 << 22),
               ("softmax", 5, 444_619, 41, 6, 63, 889_239))


def phase_walk(dev):
    """The score walk (kernel D) at WALK_SHAPES on seeded complete trees
    (``ref.random_tree``) and uniform codes in [0, 257) against n_num 255
    (so the missing code takes the numeric predicates' false side): the
    kernel's labels bit-equal to the plain walk's and to a second
    launch; CUDA-event ms (10 wrapper calls), device ms (the profiler's
    ``walk_kernel`` spans), the plain walk's ms, the bound (bytes: M K 4
    codes read, T M 4 labels written) and its share of the device time."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import random_tree
    from repro_torch.kernels.walk import walk_plain
    rows = {}
    for name, t, m, k, steps, nodes, slots in WALK_SHAPES:
        made = [random_tree(7 + i, k=k, n_bins=255, depth=steps, slots=slots,
                            leaf_p=0.0, root_count=m) for i in range(t)]
        need(all(n == nodes for _, n in made), f"walk {name}: tree size")
        fields = {f: torch.stack([tr[f] for tr, _ in made]).to(dev)
                  for f in made[0][0]}
        g = torch.Generator(device=dev).manual_seed(11)
        bins = torch.randint(0, 257, (m, k), generator=g, device=dev,
                             dtype=torch.int32)
        n_num = torch.full((k,), 255, dtype=torch.int32, device=dev)

        def kernel():
            return ops.walk(fields, bins, n_num, num_steps=steps,
                            n_nodes=nodes)

        got, again = kernel(), kernel()
        want = walk_plain(fields, bins, n_num, steps=steps)
        torch.cuda.synchronize()
        line = dict(shape=dict(trees=t, rows=m, features=k, steps=steps,
                               nodes=nodes, slots=slots),
                    rule="bit for bit", bit_equal=bool(torch.equal(got, want)),
                    two_launches_equal=bool(torch.equal(got, again)))
        del got, again, want
        line["ms"] = cuda_ms(kernel)
        line["device_ms"] = device_ms(kernel, ("walk_kernel",))
        line["plain_ms"] = cuda_ms(
            lambda: walk_plain(fields, bins, n_num, steps=steps), reps=3,
            warmup=1)
        line["bound_ms"], line["bound_by"] = bound(m * k * 4 + t * m * 4, 0)
        line["share_of_bound"] = line["bound_ms"] / line["device_ms"]
        say(f"  walk {name}", json.dumps(line))
        rows[name] = line
        del fields, bins
        torch.cuda.empty_cache()
    bad = [f"{k_}: {v}" for k_, v in rows.items()
           if not (v["bit_equal"] and v["two_launches_equal"])]
    need(not bad, f"walk: kernel != plain: {bad}")
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def _split_rows(table, y, seed):
    """Seeded 90/10 train/test split of a binned table's rows."""
    from repro_torch.core.binning import BinnedTable
    perm = np.random.default_rng(seed).permutation(len(y))
    n_test = len(y) // 10
    te, tr = perm[:n_test], perm[n_test:]
    train = BinnedTable(bins=table.bins[tr], n_num=table.n_num,
                        n_cat=table.n_cat, metas=table.metas,
                        n_bins=table.n_bins)
    return train, y[tr], table.bins[te], y[te]


def _timed_build(table, y, cfg, dev, **kw):
    import torch
    from repro_torch.core import build_tree
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = build_tree(table, y, cfg, n_classes=N_CLASS, device=dev, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    return tree, secs, launches, peak


def _level_stats(tree, s_cap, paired):
    """Width of every level and its chunk count, as the builder chunked it
    (slots per chunk: min(s_cap, max(16, next pow2)), made even when
    sibling subtraction pairs the slots)."""
    d = tree.depth[:tree.n_nodes].cpu().numpy()
    widths = np.bincount(d)[1:]
    chunks = []
    for w in widths:
        s = min(s_cap, max(16, 1 << (int(w) - 1).bit_length()))
        if paired and s % 2 and s > 1:
            s -= 1
        chunks.append(-(-int(w) // s))
    return widths.tolist(), chunks


def _differing(a, b, score_tol=0.0):
    """Fields on which two trees differ: the structural ones exactly, the
    split score to rtol = atol = ``score_tol``."""
    if a.n_nodes != b.n_nodes:
        return ["n_nodes"]
    n = a.n_nodes
    out = [f for f in TREE_FIELDS_EXACT
           if not np.array_equal(getattr(a, f)[:n].cpu().numpy(),
                                 getattr(b, f)[:n].cpu().numpy())]
    sa, sb = a.score[:n].cpu().numpy(), b.score[:n].cpu().numpy()
    if not (np.array_equal(sa, sb) if score_tol == 0
            else np.allclose(sa, sb, rtol=score_tol, atol=score_tol)):
        out.append("score")
    return out


def _first_diff_node(a, b):
    n = min(a.n_nodes, b.n_nodes)
    for f in ("feat", "op", "tbin", "count", "left", "label", "leaf"):
        ne = np.nonzero(getattr(a, f)[:n].cpu().numpy()
                        != getattr(b, f)[:n].cpu().numpy())[0]
        if ne.size:
            return int(ne[0])
    return n


def _node_top2(tree, node, table, y, dev):
    """Top-two (score, feat, op, bin) candidates of ``node``'s histogram
    under the kernel selection rule, computed on ``dev``."""
    import torch
    from repro_torch.core import paths
    from repro_torch.kernels import ops
    p = paths(tree, table.bins, table.n_num, device=dev)
    rows = (p == node).any(dim=1)
    bins = torch.as_tensor(table.bins, device=dev)
    y = torch.as_tensor(y, device=dev).long()
    stats = torch.nn.functional.one_hot(y, N_CLASS).float()
    slot = torch.where(rows, 0, -1).to(torch.int32)
    h = ops.histogram(bins, stats, slot, num_slots=1,
                      n_bins=int(table.n_bins))
    score, tbin, op = ops.split_scan(
        h, torch.as_tensor(table.n_num, device=dev),
        torch.as_tensor(table.n_cat, device=dev))
    order = torch.argsort(score[0], descending=True, stable=True)[:2]
    return [(float(score[0, f]), int(f), int(op[0, f]), int(tbin[0, f]))
            for f in order]


def kdd99_table():
    """The synthetic KDD99-10% twin, binned on the host: (table, y, fit_bins
    seconds)."""
    from repro_torch.core import fit_bins
    from repro_torch.data import synth_kdd99
    t0 = time.perf_counter()
    cols, y = synth_kdd99(M_ROWS, seed=0)
    t1 = time.perf_counter()
    table = fit_bins(cols)
    bin_secs = time.perf_counter() - t1
    del cols
    need(table.bins.shape == (M_ROWS, N_FEAT) and table.n_bins == 257,
         f"KDD99 twin binned to {table.bins.shape}, B={table.n_bins}")
    say(f"  data: synth_kdd99 {t1 - t0:.1f} s, fit_bins {bin_secs:.1f} s "
        f"(host); bins {table.bins.shape} B={table.n_bins} C={N_CLASS}")
    return table, y, bin_secs


def _paper_config():
    from repro_torch.core import TreeConfig
    return TreeConfig(max_depth=64, min_samples_split=2, heuristic="info_gain",
                      hist_backend="kernel", select_backend="kernel")


def phase_kdd99(dev, table, y, bin_secs):
    import torch
    from repro_torch.core import predict_bins
    train, y_tr, te_bins, y_te = _split_rows(table, y, seed=0)
    cfg = _paper_config()
    tree, secs, launches, peak = _timed_build(train, y_tr, cfg, dev)
    acc_tr = float((predict_bins(tree, train.bins, train.n_num, device=dev)
                    .cpu().numpy() == y_tr).mean())
    acc_te = float((predict_bins(tree, te_bins, train.n_num, device=dev)
                    .cpu().numpy() == y_te).mean())
    widths, chunks = _level_stats(tree, 1273, paired=True)
    stats = dict(n_nodes=tree.n_nodes, depth=tree.max_tree_depth,
                 levels=len(widths), widest_level=max(widths),
                 train_acc=acc_tr, test_acc=acc_te, build_s=secs,
                 binning_s=bin_secs, peak_device_bytes=peak,
                 launches=launches)
    say("  kdd99", json.dumps(stats))
    need(tree.n_nodes > 1 and acc_te > 0.9, f"kdd99 tree too weak: {stats}")
    for name in ("histogram", "histogram_pairs", "histogram_fused",
                 "split_scan"):
        need(launches[name] > 0, f"kdd99 build never launched {name}")

    cpu_tree, cpu_secs, cpu_launches, _ = _timed_build(
        train, y_tr, cfg, torch.device("cpu"))
    need(set(cpu_launches.values()) == {0}, "the CPU build launched a kernel")
    # logf on the card and torch.log on the CPU may differ in the last
    # place, so scores are held to the split scan's rtol = atol = 1e-5,
    # the structure exactly
    diff = _differing(tree, cpu_tree, score_tol=1e-5)
    near_ties = 0
    if diff:
        node = _first_diff_node(tree, cpu_tree)
        need(node < min(tree.n_nodes, cpu_tree.n_nodes),
             f"card and CPU trees differ ({diff}) with no differing node")
        top_card = _node_top2(tree, node, train, y_tr, dev)
        top_cpu = _node_top2(cpu_tree, node, train, y_tr, torch.device("cpu"))
        say(f"  first differing node {node} (fields {diff}); top-two "
            f"(score, feat, op, bin) card {top_card} cpu {top_cpu}")
        s_hi = top_card[0][0]
        tie = all(abs(t[0][0] - t[1][0]) <= 1e-6 * abs(s_hi)
                  for t in (top_card, top_cpu))
        need(tie, f"card and CPU trees differ at node {node} and it is not a "
                  f"float near-tie")
        near_ties = 1
    n = min(tree.n_nodes, cpu_tree.n_nodes)
    score_diff = float(np.abs(tree.score[:n].cpu().numpy()
                              - cpu_tree.score[:n].numpy()).max())
    say(f"  kdd99 card tree vs CPU plain-version tree: "
        f"{'identical' if not diff else 'differ'} (structure exact, score "
        f"max abs diff {score_diff:.3g}); near_ties={near_ties}; "
        f"cpu build {cpu_secs:.1f} s")
    return launches, stats, tree


def _union_us(spans):
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _profiled_build(table, y, cfg, dev, build_s):
    """One more build under torch.profiler (CUDA activity): the summed
    device time of each repro_torch kernel and of everything else on the
    device, the device's busy span and its idle share of the host-clock
    build time.  The profiler slows the host, so its own wall time is
    printed apart and ``build_s`` is the unprofiled build's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import build_tree
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        build_tree(table, y, cfg, n_classes=N_CLASS, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ours, other, spans = {}, 0.0, []
    for ev in prof.events():
        # the device side of the program's spans (repro_torch.tracing) is
        # a range over the work it launched, not work of its own
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        key = ev.name.split("(anonymous namespace)::", 1)[-1].split("(")[0]
        if key.split("<")[0] in KERNEL_FUNCTIONS:
            ours[key] = ours.get(key, 0.0) + (b - a) / 1e3
        else:
            other += (b - a) / 1e3
    if not spans:
        say("  wide sub_off profile: the profiler saw no device time")
        return
    busy_ms = _union_us(spans) / 1e3
    out = dict(build="sub_off (profiled)", build_s=build_s,
               profiled_wall_s=wall,
               kernel_ms={k: ours[k] for k in sorted(ours)},
               kernels_total_ms=sum(ours.values()), other_device_ms=other,
               device_busy_ms=busy_ms,
               device_idle_share=1.0 - busy_ms / (build_s * 1e3),
               device_idle_share_profiled=1.0 - busy_ms / (wall * 1e3))
    say("  wide profile", json.dumps(out))


def phase_wide(dev, rows):
    from repro_torch.core import TreeConfig, fit_bins, predict_bins
    from repro_torch.core.tree import _auto_chunk_slots
    from repro_torch.data import make_classification
    say(f"  rows {rows} (of {M_ROWS}), K={N_FEAT}")
    t0 = time.perf_counter()
    cols, y = make_classification(rows, N_FEAT, N_CLASS, seed=1,
                                  n_cat_features=3, missing_frac=0.01)
    t1 = time.perf_counter()
    table = fit_bins(cols)
    bin_secs = time.perf_counter() - t1
    del cols
    say(f"  data: make_classification {t1 - t0:.1f} s, fit_bins "
        f"{bin_secs:.1f} s (host); bins {table.bins.shape} B={table.n_bins}")
    train, y_tr, te_bins, y_te = _split_rows(table, y, seed=1)
    base = dict(max_depth=64, hist_backend="kernel", select_backend="kernel")
    s_cap = _auto_chunk_slots(N_FEAT, int(table.n_bins), N_CLASS, 1 << 28)
    total = {}
    results = {}
    # weighted classification builds without subtraction (its exactness
    # contract), so only sub_on pairs its slots
    for name, cfg, kw in (
            ("sub_on", TreeConfig(**base), {}),
            ("sub_off", TreeConfig(**base, sibling_subtraction=False), {}),
            ("unit_weights", TreeConfig(**base),
             dict(sample_weight=np.ones(len(y_tr), np.float32)))):
        tree, secs, launches, peak = _timed_build(train, y_tr, cfg, dev, **kw)
        widths, chunks = _level_stats(tree, s_cap, paired=name == "sub_on")
        acc_te = float((predict_bins(tree, te_bins, train.n_num, device=dev)
                        .cpu().numpy() == y_te).mean())
        acc_tr = float((predict_bins(tree, train.bins, train.n_num, device=dev)
                        .cpu().numpy() == y_tr).mean())
        stats = dict(build=name, n_nodes=tree.n_nodes,
                     depth=tree.max_tree_depth, levels=len(widths),
                     widest_level=max(widths), max_chunks_per_level=max(chunks),
                     chunks_per_level=chunks, train_acc=acc_tr,
                     test_acc=acc_te, build_s=secs, binning_s=bin_secs,
                     peak_device_bytes=peak, launches=launches)
        say("  wide", json.dumps(stats))
        results[name] = (tree, stats)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    _profiled_build(train, y_tr, TreeConfig(**base, sibling_subtraction=False),
                    dev, results["sub_off"][1]["build_s"])
    on, off, unit = (results[n][0] for n in ("sub_on", "sub_off",
                                             "unit_weights"))
    need(results["sub_on"][1]["max_chunks_per_level"] > 1,
         "the wide phase never ran a level of more than one chunk")
    need(not _differing(on, off), f"subtraction on != off: {_differing(on, off)}")
    need(not _differing(unit, off),
         f"unit weights != unweighted: {_differing(unit, off)}")
    need(results["unit_weights"][1]["launches"]["histogram_weights"] > 0,
         "the weighted build never launched the weights mode")
    say("  wide: subtraction on == off == unit weights, field for field")
    return total, results["sub_on"][1]


# ---------------------------------------------------------------------------
# phases toot and gbt: Training-Only-Once Tuning and Newton / GOSS boosting
# ---------------------------------------------------------------------------

def _oracle_cells(shape, n_interior, seed=0):
    """Every corner of the grid plus ``n_interior`` seeded interior cells
    (the retrain-oracle subset of the JAX package's TOOT benchmark)."""
    corners = [tuple(c) for c in
               np.stack(np.meshgrid(*[[0, n - 1] for n in shape],
                                    indexing="ij"), -1).reshape(-1, len(shape))]
    rng = np.random.default_rng(seed)
    interior = [tuple(int(rng.integers(0, n)) for n in shape)
                for _ in range(n_interior)]
    return list(dict.fromkeys(corners + interior))


def _sync_clock(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def phase_toot(dev, table, y, smi):
    """One full tree on the KDD99 twin (kernel histograms, torch selection,
    so that min_child_weight can be retrained), its design space priced on
    the card and on the CPU (equal grids), and the oracle cells retrained
    on the card (zero mismatches)."""
    import torch
    from repro_torch.core import (SweepSpace, TreeConfig, build_tree,
                                  predict_bins, prune_stats, sweep)
    from repro_torch.kernels import ops
    train, y_tr, val_bins, y_val = _split_rows(table, y, seed=0)

    def config(**kw):
        return TreeConfig(hist_backend="kernel", select_backend="torch", **kw)

    ops.reset_launch_counts()
    t0 = _sync_clock(dev)
    full = build_tree(train, y_tr, config(max_depth=64), n_classes=N_CLASS,
                      device=dev)
    build_s = _sync_clock(dev) - t0
    launches = ops.launch_counts()
    space = SweepSpace(mcw_values=(0.0, 1.0, 5.0, 25.0))
    t0 = _sync_clock(dev)
    res = sweep(full, val_bins, y_val, train.n_num, space=space,
                train_size=len(y_tr), device=dev)
    sweep_s = _sync_clock(dev) - t0
    t0 = time.perf_counter()
    cpu = sweep(full, val_bins, y_val, train.n_num, space=space,
                train_size=len(y_tr), device="cpu")
    cpu_s = time.perf_counter() - t0
    for f in ("metric", "n_nodes", "walk_bytes"):
        need(np.array_equal(getattr(res, f), getattr(cpu, f)),
             f"toot: the card's {f} grid differs from the CPU sweep")
    need(res.front == cpu.front and res.best == cpu.best,
         "toot: the card's Pareto front or best cell differs from the CPU's")
    mismatches, cells = 0, _oracle_cells(res.metric.shape, 4)
    for i, j, k in cells:
        d, smin, w = int(res.dmax[i]), int(res.smin[j]), float(res.mcw[k])
        rt = build_tree(train, y_tr, config(max_depth=d, min_samples_split=smin,
                                            min_child_weight=w),
                        n_classes=N_CLASS, device=dev)
        acc = float((predict_bins(rt, val_bins, train.n_num, device=dev)
                     .cpu().numpy() == y_val).mean())
        if (res.metric[i, j, k] != acc
                or res.n_nodes[i, j, k] != prune_stats(full, d, smin, w)[0]):
            mismatches += 1
            say(f"  toot oracle mismatch at dmax={d} smin={smin} mcw={w}: "
                f"sweep {res.metric[i, j, k]} nodes {res.n_nodes[i, j, k]}, "
                f"retrained {acc}")
    stats = dict(n_nodes=full.n_nodes, depth=full.max_tree_depth,
                 build_s=build_s, configs=int(res.n_configs),
                 grid=list(res.metric.shape), sweep_s=sweep_s,
                 configs_per_s=res.n_configs / sweep_s, cpu_sweep_s=cpu_s,
                 oracle_cells=len(cells), oracle_mismatches=mismatches,
                 best=res.best.config, best_metric=res.best.metric,
                 front_size=len(res.front), launches=launches, card=smi)
    say("  toot", json.dumps(stats))
    need(mismatches == 0, f"toot: {mismatches} oracle cells differ from "
                          "their retrained trees")
    need(res.n_configs >= 200, "toot priced fewer than 200 configs")
    for name in ("histogram", "histogram_fused"):
        need(launches[name] > 0, f"the toot build never launched {name}")
    return launches


def _same_trees(a, b):
    """Two tree lists equal bit for bit in every field."""
    import torch
    from repro_torch.core.tree import TREE_FIELDS
    return len(a) == len(b) and all(
        ta.n_nodes == tb.n_nodes
        and all(torch.equal(getattr(ta, f), getattr(tb, f))
                for f in TREE_FIELDS)
        for ta, tb in zip(a, b))


def phase_gbt(dev, table, y, smi):
    """Logistic Newton boosting with GOSS on the KDD99 twin's binary target
    (normal vs attack): two fits give the same trees bit for bit, the
    ensemble sweep equals refits at the oracle cells, and the holdout
    accuracy beats the base rate."""
    import torch
    from repro_torch.core import SweepSpace, predict_bins
    from repro_torch.kernels import ops
    yb = (y != 0).astype(np.float32)                  # class 0 is "normal"
    train, y_tr, val_bins, y_val = _split_rows(table, yb, seed=0)
    n_trees, lr, depth = 20, 0.3, 6

    def timed_fit(r):
        t0 = _sync_clock(dev)
        ens = _logistic_model(r).fit(train, y_tr, device=dev)
        return ens, _sync_clock(dev) - t0

    ops.reset_launch_counts()
    ens, fit_s = timed_fit(n_trees)
    launches = ops.launch_counts()
    again, fit2_s = timed_fit(n_trees)
    deterministic = _same_trees(ens.trees, again.trees)
    space = SweepSpace(dmax_values=(2, depth), smin_values=(0, 20),
                       mcw_values=(0.0, 4.0),
                       n_rounds_values=tuple(range(1, n_trees + 1)))
    t0 = _sync_clock(dev)
    res = ens.sweep(val_bins, y_val, space=space, train_size=len(y_tr))
    sweep_s = _sync_clock(dev) - t0
    refits = {n_trees: again}            # the second fit is the 20-round refit
    mismatches, cells = 0, _oracle_cells(res.metric.shape, 2)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
    for r, i, j, k in cells:
        nr = int(res.n_rounds[r])
        if nr not in refits:
            refits[nr] = timed_fit(nr)[0]
        refit = refits[nr]
        raw = torch.full((len(y_val),), refit.base, dtype=torch.float32,
                         device=dev)
        for t in refit.trees:                         # fit-order accumulation
            raw = raw + lr_t * predict_bins(
                t, val_bins, train.n_num, max_depth=int(res.dmax[i]),
                min_samples_split=int(res.smin[j]),
                min_child_weight=float(res.mcw[k]), num_steps=depth,
                device=dev)
        acc = float(((raw > 0).int().cpu().numpy() == y_val).mean())
        if res.metric[r, i, j, k] != acc:
            mismatches += 1
            say(f"  gbt oracle mismatch at r={nr} cell {(i, j, k)}: sweep "
                f"{res.metric[r, i, j, k]}, refit {acc}")
    acc = float((ens.predict(val_bins) == y_val).mean())
    base_rate = float(max(y_val.mean(), 1.0 - y_val.mean()))
    stats = dict(rows=len(y_tr), n_trees=n_trees, fit_s=fit_s, fit2_s=fit2_s,
                 deterministic=deterministic,
                 nodes=[t.n_nodes for t in ens.trees[:5]],
                 configs=int(res.n_configs), sweep_s=sweep_s,
                 oracle_cells=len(cells), oracle_mismatches=mismatches,
                 refits=sorted(refits), holdout_acc=acc, base_rate=base_rate,
                 launches=launches, card=smi)
    say("  gbt", json.dumps(stats))
    need(deterministic, "gbt: two fits on the card grew different trees")
    need(mismatches == 0, f"gbt: {mismatches} ensemble oracle cells differ "
                          "from their refits")
    need(acc > base_rate, f"gbt: holdout accuracy {acc} <= base rate "
                          f"{base_rate}")
    for name in ("histogram_weights", "histogram_fused", "split_scan"):
        need(launches[name] > 0, f"the gbt fit never launched {name}")
    return launches, fit2_s, ens


# ---------------------------------------------------------------------------
# phases softmax, forest and resume: the multiclass ensembles and checkpoints
# ---------------------------------------------------------------------------

def _boosting_model(n_trees, loss):
    """Phase gbt's (``loss="logistic"``) and phase softmax's ensemble: 20
    rounds in the phases, depth 6, GOSS(0.2, 0.2), kernel backends."""
    from repro_torch.core import GossConfig, GradientBoostedTrees, TreeConfig
    return GradientBoostedTrees(
        n_trees=n_trees, learning_rate=0.3,
        config=TreeConfig(max_depth=6, task="regression_variance",
                          hist_backend="kernel", select_backend="kernel"),
        loss=loss, goss=GossConfig(0.2, 0.2), seed=0)


def _logistic_model(n_trees):
    return _boosting_model(n_trees, "logistic")


def _softmax_model(n_trees):
    return _boosting_model(n_trees, "softmax")


def _forest_model():
    from repro_torch.core import RandomForest, TreeConfig
    return RandomForest(n_trees=10, max_features=0.7,
                        config=TreeConfig(max_depth=24, hist_backend="kernel",
                                          select_backend="kernel"), seed=0)


def _lockstep_chunks(trees, n_class, s_cap):
    """Level chunks of the multiclass fit: per round, per depth, the widest
    class's level cut into chunks of min(s_cap, max(16, next pow2))."""
    total = 0
    for r in range(0, len(trees), n_class):
        widths = np.stack([np.bincount(t.depth[:t.n_nodes].cpu().numpy(),
                                       minlength=65)[1:]
                           for t in trees[r:r + n_class]]).max(axis=0)
        for w in widths[widths > 0]:
            s = min(s_cap, max(16, 1 << (int(w) - 1).bit_length()))
            s -= s % 2
            total += -(-int(w) // s)
    return total


def _softmax_round0(dev, lo, goss, train, y_tr):
    """Round 0 of a softmax GOSS fit (loss ``lo``, ``goss``) by hand: the
    same GOSS draw (a fresh generator's first) and Newton targets.  Returns
    the sampled rows as a host table, the class targets ``z [C, n]`` and
    the build weights ``w [C, n]`` (GOSS amplification x hessian) on the
    card."""
    import torch
    from repro_torch.core.forest import _goss_sample
    yt = torch.as_tensor(y_tr, device=dev).long()
    raw = lo.base_score(yt)[:, None].expand(N_CLASS, len(y_tr))
    g, h = lo.grad_hess(yt, raw)
    z = lo.newton_target(g, h)
    top_n, other_n = goss.sample_sizes(len(y_tr))
    idx, w = _goss_sample(torch.sqrt(torch.sum(g * g * h, dim=0)),
                          torch.Generator(device=dev).manual_seed(0),
                          top_n=top_n, other_n=other_n,
                          amp=goss.amplification)
    sub = type(train)(bins=train.bins[idx.cpu().numpy()], n_num=train.n_num,
                      n_cat=train.n_cat, metas=train.metas,
                      n_bins=train.n_bins)
    return sub, z[:, idx].contiguous(), (w[None] * h[:, idx]).contiguous()


def phase_softmax(dev, table, y, smi, gbt_fit_s):
    """Softmax Newton boosting with GOSS on the KDD99 twin's 5 classes: each
    round's 5 class-trees through one batched build (one class-stacked
    histogram launch and one scan launch per level chunk).  Two fits give
    the same trees bit for bit, round 0's batched trees equal 5 card
    ``build_tree`` calls on the same rows and weights, the holdout
    accuracy beats the base rate, and the stacked launches equal the level
    chunks."""
    import torch
    from repro_torch.core import build_tree
    from repro_torch.core.tree import _auto_chunk_slots
    from repro_torch.kernels import ops
    train, y_tr, val_bins, y_val = _split_rows(table, y, seed=0)
    n_trees = 20

    def timed_fit():
        t0 = _sync_clock(dev)
        ens = _softmax_model(n_trees).fit(train, y_tr, device=dev)
        return ens, _sync_clock(dev) - t0

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ens, fit_s = timed_fit()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    again, fit2_s = timed_fit()
    deterministic = _same_trees(ens.trees, again.trees)
    del again
    # round 0 by hand: the same GOSS draw and weights, one card build per
    # class
    sub, zs, ws = _softmax_round0(dev, ens._fitted_loss(), ens.goss, train,
                                  y_tr)
    per_class = [build_tree(sub, zs[c], ens.config, sample_weight=ws[c],
                            device=dev)
                 for c in range(N_CLASS)]
    round0_equal = _same_trees(ens.trees[:N_CLASS], per_class)
    s_cap = _auto_chunk_slots(N_FEAT, 257, 3, ens.config.hist_budget_bytes)
    chunks = _lockstep_chunks(ens.trees, N_CLASS, s_cap)
    pred = ens.predict(val_bins)
    acc = float((pred == y_val).mean())
    base_rate = float(np.bincount(y_val).max() / len(y_val))
    proba = ens.predict_proba(val_bins)
    stats = dict(rows=len(y_tr), gossed_rows=int(zs.shape[1]),
                 classes=N_CLASS, n_trees=n_trees, trees=len(ens.trees),
                 fit_s=fit_s, fit2_s=fit2_s,
                 fit2_s_over_5x_gbt_fit2_s=fit2_s / (5 * gbt_fit_s),
                 deterministic=deterministic, round0_equal=round0_equal,
                 level_chunks=chunks, holdout_acc=acc, base_rate=base_rate,
                 proba_row_sum_max_err=float(np.abs(proba.sum(1) - 1).max()),
                 peak_device_bytes=peak, launches=launches, card=smi)
    say("  softmax", json.dumps(stats))
    need(deterministic, "softmax: two fits on the card grew different trees")
    need(round0_equal, "softmax: round 0's batched class-trees differ from "
                       "per-class card builds")
    need(acc > base_rate, f"softmax: holdout accuracy {acc} <= base rate "
                          f"{base_rate}")
    need(launches["histogram_stacked"] == chunks,
         f"softmax: {launches['histogram_stacked']} stacked launches for "
         f"{chunks} level chunks")
    need(launches["split_scan"] == chunks and launches["histogram"] == 0,
         f"softmax: scan launches {launches['split_scan']}, one-lane plain "
         f"launches {launches['histogram']} (want {chunks} and 0)")
    for name in ("histogram_weights", "histogram_fused"):
        need(launches[name] > 0, f"the softmax fit never launched {name}")
    return launches, fit2_s


def phase_forest(dev, table, y, smi):
    """RandomForest on the KDD99 twin's 5 classes: 10 bootstrapped,
    feature-masked trees at depth 24 with kernel backends.  Its votes equal
    a per-tree ``predict_bins`` vote loop, two fits are identical, and the
    holdout accuracy is above 0.9."""
    import torch
    from repro_torch.core import predict_bins
    from repro_torch.kernels import ops
    train, y_tr, val_bins, y_val = _split_rows(table, y, seed=0)

    def timed_fit():
        t0 = _sync_clock(dev)
        rf = _forest_model().fit(train, y_tr, device=dev)
        return rf, _sync_clock(dev) - t0

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rf, fit_s = timed_fit()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    again, fit2_s = timed_fit()
    identical = _same_trees(rf.trees, again.trees)
    votes = rf.predict_raw(val_bins)
    loop = np.zeros_like(votes)
    for tree, nn in zip(rf.trees, rf.n_nums):
        pred = predict_bins(tree, val_bins, nn, device=dev).cpu().numpy()
        loop[np.arange(len(y_val)), pred.astype(np.int64)] += 1
    acc = float((rf.predict(val_bins) == y_val).mean())
    stats = dict(rows=len(y_tr), n_trees=10, fit_s=fit_s, fit2_s=fit2_s,
                 identical=identical, votes_equal_loop=bool(
                     np.array_equal(votes, loop)),
                 nodes=[t.n_nodes for t in rf.trees],
                 numeric_features_per_tree=[int((nn > 0).sum())
                                            for nn in rf.n_nums],
                 holdout_acc=acc, peak_device_bytes=peak, launches=launches,
                 card=smi)
    say("  forest", json.dumps(stats))
    need(stats["votes_equal_loop"], "forest: votes differ from a per-tree "
                                    "vote loop")
    need(identical, "forest: two fits grew different trees")
    need(acc > 0.9, f"forest: holdout accuracy {acc} <= 0.9")
    for name in ("histogram", "histogram_pairs", "histogram_fused",
                 "split_scan"):
        need(launches[name] > 0, f"the forest fit never launched {name}")
    return launches, rf, fit2_s


class _Interrupt(Exception):
    pass


def _interrupted(save, at):
    """A callback that saves, then stops the fit after step ``at`` (a
    preemption between rounds or levels)."""
    def callback(state):
        save(state)
        if getattr(state, "round", None) == at or (
                not hasattr(state, "round") and state.depth == at):
            raise _Interrupt
    return callback


def phase_resume(dev, table, y, smi):
    """Three interrupted runs, each resumed from its checkpoint directory
    and equal bit for bit to the uninterrupted run: the 20-round logistic
    GOSS fit of phase gbt stopped after round 7, a 6-round softmax fit
    stopped after round 3, and the kdd99 build stopped after level 4."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import (RoundCheckpointer, TreeCheckpointer,
                                        restore_build_state)
    from repro_torch.core import TreeConfig, build_tree
    from repro_torch.kernels import ops
    train, y_tr, val_bins, _ = _split_rows(table, y, seed=0)
    yb = (y_tr != 0).astype(np.float32)
    root = tempfile.mkdtemp(prefix="udt_resume_")
    out = {}
    ops.reset_launch_counts()
    try:
        for name, make, labels, at, every in (
                ("gbt_logistic", lambda: _logistic_model(20), yb, 7, 7),
                ("softmax", lambda: _softmax_model(6), y_tr, 3, 3)):
            d = f"{root}/{name}"
            t0 = _sync_clock(dev)
            full = make().fit(train, labels, device=dev)
            full_s = _sync_clock(dev) - t0
            try:
                make().fit(train, labels, device=dev,
                           round_callback=_interrupted(
                               RoundCheckpointer(d, every=every), at))
                raise SmokeFailure(f"resume {name}: the fit was not "
                                   "interrupted")
            except _Interrupt:
                pass
            t0 = _sync_clock(dev)
            resumed = make().fit(train, labels, device=dev, resume_from=d)
            resumed_s = _sync_clock(dev) - t0
            same = (_same_trees(full.trees, resumed.trees)
                    and np.array_equal(full.predict_raw(val_bins),
                                       resumed.predict_raw(val_bins)))
            out[name] = dict(interrupted_after_round=at,
                             trees=len(full.trees), bit_identical=same,
                             full_fit_s=full_s, resumed_fit_s=resumed_s)
            need(same, f"resume {name}: the resumed fit differs from the "
                       "uninterrupted one")
        cfg = TreeConfig(max_depth=64, heuristic="info_gain",
                         hist_backend="kernel", select_backend="kernel")
        d = f"{root}/kdd99"
        full = build_tree(train, y_tr, cfg, n_classes=N_CLASS, device=dev)
        try:
            build_tree(train, y_tr, cfg, n_classes=N_CLASS, device=dev,
                       level_callback=_interrupted(TreeCheckpointer(d), 5))
            raise SmokeFailure("resume kdd99: the build was not interrupted")
        except _Interrupt:
            pass
        state = restore_build_state(d)
        resumed = build_tree(train, y_tr, cfg, n_classes=N_CLASS, device=dev,
                             resume=state)
        same = _same_trees([full], [resumed])
        out["kdd99_build"] = dict(interrupted_after_level=state.depth - 1,
                                  with_phist=state.phist is not None,
                                  n_nodes=full.n_nodes, bit_identical=same)
        need(same, "resume kdd99: the resumed build differs from the "
                   "uninterrupted one")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = ops.launch_counts()
    out["launches"] = launches
    out["card"] = smi
    say("  resume", json.dumps(out))
    need(launches["histogram_stacked"] > 0 and launches["split_scan"] > 0,
         "the resume phase never launched the kernels")
    torch.cuda.synchronize()
    return launches


# ---------------------------------------------------------------------------
# phases serve and chaos: forest serving and the chaos scenario
# ---------------------------------------------------------------------------

def _differing_values(a, b):
    """Values of two float32 arrays that differ bit for bit (NaN-safe)."""
    a, b = np.ascontiguousarray(a, np.float32), np.ascontiguousarray(
        b, np.float32)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int((a.view(np.uint32) != b.view(np.uint32)).sum())


def _percentiles_ms(fn, calls=200, warmup=20):
    """p50 / p99 host milliseconds of ``fn()`` (each call ends on the host
    with its result, so no extra synchronise is needed)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times, 50)), float(np.percentile(times, 99))


def phase_serve(dev, table, y, smi, t0_ens):
    """Forest serving on the card.  Tenant t0 is phase gbt's fit; tenant t1
    (normal-or-other vs dos, depth 8) is fitted here through the kernels.
    Both are packed into a ``ModelRegistry(capacity=4)`` behind a
    ``ForestServer`` with buckets 1/8/64/512, which replays one CUDA graph
    per (bucket, model-set shape).  Served outputs must equal each
    tenant's ``predict_proba_device`` on the card bit for bit, and the
    captures must follow the envelope: 4, +0 on a second pass, +4 after
    t1 grows it, +0 after removing and re-adding t0, +0 after poisoning
    t1 (whose request then fails with ``NonFiniteOutputError`` while t0's,
    in the same flush, stays bit-exact)."""
    import torch
    from repro_torch.core import GossConfig, GradientBoostedTrees, TreeConfig
    from repro_torch.kernels import ops
    from repro_torch.resilience import poison_tenant
    from repro_torch.serve import (BatchPolicy, ForestServer, ModelRegistry,
                                   NonFiniteOutputError, pack_trees)
    from repro_torch.serve.registry import routed_forest_walk
    train, y_tr, val_bins, _ = _split_rows(table, y, seed=0)
    n_val = len(val_bins)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_fit = _sync_clock(dev)
    t1_ens = GradientBoostedTrees(
        n_trees=20, learning_rate=0.3,
        config=TreeConfig(max_depth=8, task="regression_variance",
                          hist_backend="kernel", select_backend="kernel"),
        loss="logistic", goss=GossConfig(0.2, 0.2), seed=0).fit(
            train, (y_tr == 1).astype(np.float32), device=dev)
    fit_s = _sync_clock(dev) - t_fit
    want = {0: t0_ens.predict_proba_device(val_bins).cpu().numpy(),
            1: t1_ens.predict_proba_device(val_bins).cpu().numpy()}
    t_pack = time.perf_counter()
    packed = {0: pack_trees(t0_ens), 1: pack_trees(t1_ens)}
    pack_s = time.perf_counter() - t_pack
    reg = ModelRegistry(capacity=4, device=dev)
    server = ForestServer(reg, BatchPolicy(buckets=(1, 8, 64, 512)))
    mids, diffs, captures = {}, {}, []

    def serve_pass(tag, tenant):
        """The whole holdout in 512-row requests, then sizes 1, 8, 64."""
        mid = mids[tenant]
        got = np.concatenate([server.predict(mid, val_bins[i:i + 512])
                              for i in range(0, n_val, 512)])
        d = _differing_values(got, want[tenant])
        for n in (1, 8, 64):
            d += _differing_values(server.predict(mid, val_bins[:n]),
                                   want[tenant][:n])
        diffs[tag] = d

    def capture_step(tag):
        captures.append((tag, server.compile_count))

    mids[0] = reg.add("t0", packed[0])
    sig0 = reg.shape_sig
    serve_pass("t0", 0)
    capture_step("t0 alone")
    serve_pass("t0 again", 0)
    capture_step("second pass")

    mids[1] = reg.add("t1", packed[1])
    sig1 = reg.shape_sig
    serve_pass("t1 after growth", 1)
    capture_step("t1 added")
    serve_pass("t0 after growth", 0)
    # a mixed flush: 7-row requests of t0 and t1 in turn, then an
    # oversize 1,000-row t1 request that pushes the queue past max_batch
    reqs = []
    for j in range(70):
        tenant = j % 2
        lo = 7 * j
        reqs.append((tenant, lo, lo + 7,
                     server.submit(mids[tenant], val_bins[lo:lo + 7])))
    reqs.append((1, 2000, 3000, server.submit(mids[1],
                                              val_bins[2000:3000])))
    server.flush()
    diffs["mixed + oversize"] = sum(
        _differing_values(p.result(), want[t][lo:hi])
        for t, lo, hi, p in reqs)
    capture_step("mixed")

    mid_before = mids[0]
    reg.remove("t0")
    mids[0] = reg.add("t0", packed[0])
    serve_pass("t0 re-added", 0)
    serve_pass("t1 beside re-added t0", 1)
    capture_step("remove + re-add t0")
    need(mids[0] == mid_before and reg.shape_sig == sig1,
         "serve: re-adding t0 did not reuse its slot inside the envelope")

    # the latency numbers, on healthy tenants
    rows = {n: val_bins[:n] for n in (1, 8, 64, 512)}
    latency = {}
    for n, r in rows.items():
        p50, p99 = _percentiles_ms(lambda: server.predict(mids[0], r))
        padded = reg.pad_bins(r)
        b_t = torch.as_tensor(padded, device=dev)
        g_t = torch.full((n,), mids[0], dtype=torch.int32, device=dev)

        def eager():
            out, ok = routed_forest_walk(reg.tables, b_t, g_t,
                                         num_steps=reg.num_steps)
            return torch.cat([out, ok.float()]).cpu()
        e50, _ = _percentiles_ms(eager)
        # the bucket's graph alone: copy in, replay, copy out
        entry = server._exec[(server.bucket_for(n), reg.shape_sig)]
        pad = entry.bins.shape[0] - n
        g_np = np.pad(np.full(n, mids[0], np.int32), (0, pad))
        r_np = np.pad(padded, ((0, pad), (0, 0)))
        r50, _ = _percentiles_ms(lambda: entry.run(g_np, r_np))
        latency[n] = dict(server_p50_ms=p50, server_p99_ms=p99,
                          replay_p50_ms=r50, eager_p50_ms=e50)
    t_all = time.perf_counter()
    for i in range(0, n_val, 512):
        server.predict(mids[0], val_bins[i:i + 512])
    rows_per_s = n_val / (time.perf_counter() - t_all)
    capture_step("latency runs")

    poison_tenant(reg, mids[1])
    bad = server.submit(mids[1], val_bins[:8])
    good = server.submit(mids[0], val_bins[:64])
    server.flush()
    poisoned_error = type(bad.exception()).__name__
    diffs["t0 beside poisoned t1"] = _differing_values(good.result(),
                                                       want[0][:64])
    capture_step("t1 poisoned")
    peak = torch.cuda.max_memory_allocated()
    launches = ops.launch_counts()
    counts = [c for _, c in captures]
    stats = dict(
        holdout_rows=n_val, tenants={
            name: dict(trees=p.n_trees, nodes=p.max_nodes,
                       num_steps=int(p.meta["num_steps"]),
                       record_bytes=p.record_bytes)
            for name, p in (("t0", packed[0]), ("t1", packed[1]))},
        shape_sig_t0=list(sig0), shape_sig_t0_t1=list(sig1),
        captures=dict(captures), differing_values=diffs,
        poisoned_request=poisoned_error,
        breaker_t1=server.breaker.state(mids[1]),
        latency_ms=latency, rows_per_s_bucket_512=rows_per_s,
        request_cost=reg.request_cost(), t1_fit_s=fit_s, pack_s=pack_s,
        stats=server.stats, peak_device_bytes=peak, launches=launches,
        card=smi)
    say("  serve", json.dumps(stats))
    need(all(d == 0 for d in diffs.values()),
         f"serve: outputs differ from predict_proba_device: {diffs}")
    need(counts == [4, 4, 8, 8, 8, 8, 8],
         f"serve: captures {captures}, want 4 / +0 / +4 / +0 ...")
    need(sig1 != sig0, "serve: adding the deeper t1 did not grow the "
                       "envelope")
    need(isinstance(bad.exception(), NonFiniteOutputError)
         and server.breaker.state(mids[1]) == "open",
         f"serve: the poisoned tenant resolved to {poisoned_error}, "
         f"breaker {server.breaker.state(mids[1])}")
    for name in ("histogram_weights", "histogram_fused", "split_scan"):
        need(launches[name] > 0, f"the serve phase never launched {name}")
    return launches


def phase_chaos(dev, smi):
    """``run_chaos(0)`` on the card: 14 faults, none unhandled, resume
    parity exactly 0.0, and every outcome and the shed / served / retries
    counts equal to the committed reference run (``BENCH_chaos.json``);
    turning the breaker or the digest check off leaves at least one fault
    unhandled."""
    from repro_torch.kernels import ops
    from repro_torch.resilience import run_chaos
    bench = json.loads((ROOT / "BENCH_chaos.json").read_text())
    ops.reset_launch_counts()
    t0 = _sync_clock(dev)
    rep = run_chaos(0, device=dev)
    chaos_s = _sync_clock(dev) - t0
    launches = ops.launch_counts()
    flips = {flag: run_chaos(0, device=dev, **{flag: False})["unhandled"]
             for flag in ("breaker_enabled", "digest_check")}
    got = [(o["fault"], o["outcome"]) for o in rep["outcomes"]]
    ref = [(o["fault"], o["outcome"]) for o in bench["outcomes"]]
    census = {k: (rep[k], bench[k]) for k in ("shed", "served", "retries")}
    stats = dict(faults=rep["faults_injected"], unhandled=rep["unhandled"],
                 recovered_exact=rep["recovered_exact"],
                 degraded_graceful=rep["degraded_graceful"],
                 resume_parity_max_abs=rep["resume_parity_max_abs"],
                 outcomes_equal_reference=got == ref,
                 census_port_vs_reference=census,
                 unhandled_with_guard_off=flips, chaos_s=chaos_s,
                 launches=launches, card=smi)
    say("  chaos", json.dumps(stats))
    need(rep["faults_injected"] == 14 and rep["unhandled"] == 0,
         f"chaos: {rep['faults_injected']} faults, {rep['unhandled']} "
         "unhandled")
    need(rep["resume_parity_max_abs"] == 0.0,
         f"chaos: resume parity {rep['resume_parity_max_abs']}")
    need(got == ref, f"chaos: outcomes {got} differ from the reference's")
    need(all(a == b for a, b in census.values()),
         f"chaos: shed / served / retries {census}")
    need(all(v > 0 for v in flips.values()),
         f"chaos: a disabled guard left nothing unhandled: {flips}")
    for name in ("histogram_weights", "histogram_fused", "split_scan"):
        need(launches[name] > 0, f"the chaos phase never launched {name}")
    return launches


# ---------------------------------------------------------------------------
# phase dist: the sharded build on a 1-rank NCCL group
# ---------------------------------------------------------------------------

DIST_LAYOUTS = (("composed", {}), ("psum_sub", dict(slot_scatter=False)),
                ("data_only", dict(model_axis=None)))


def _hist_per_chunk(builder, row):
    """The reference's per-chunk collective arithmetic (the module docstring
    of ``src/repro/core/distributed.py``), held call by call: the histogram
    collective of a level chunk of S slots hands in S * ``row`` bytes, the
    packed S/2 * ``row`` under sibling subtraction (split over the data
    shards when scattered: 1 here).  Reads the builder's chunk steps
    (``builder.chunks``) beside its collectives' call log.  Returns (chunks,
    reference bytes, calls that differ), per build of two."""
    hist = [c.nbytes for c in builder.comm.log if c.tag == "hist"]
    want = [(s // 2 if use else s) * row for s, use in builder.chunks]
    bad = sum(a != b for a, b in zip(hist, want)) + abs(len(hist) - len(want))
    return len(want) // 2, sum(want) // 2, bad


def _differing_nodes(a, b):
    """Nodes whose split or children differ (all of them if the sizes do)."""
    if a.n_nodes != b.n_nodes:
        return max(a.n_nodes, b.n_nodes)
    n = a.n_nodes
    diff = np.zeros(n, bool)
    for f in ("feat", "op", "tbin", "left", "right", "leaf"):
        diff |= (getattr(a, f)[:n].cpu().numpy()
                 != getattr(b, f)[:n].cpu().numpy())
    return int(diff.sum())


def _per_build(builder):
    """One build's collectives out of two equal builds on ``builder``:
    calls and bytes halved, host seconds inside the calls the mean."""
    return {k: [v[0] // 2, v[1] // 2, v[2] / 2]
            for k, v in builder.comm.counts.items()}


def _sharded_replay(dev, model, train, labels):
    """The local loop fed the sharded fit's draw on one data shard (the
    card's 1x1 mesh): each round ``goss_sample_sharded_ref`` on the loop's
    own leverage with the fit's round seed, a local card build on the
    selected rows with the same weights (GOSS weight x hessian), the plain
    walk.  Returns a copy of ``model`` holding the loop's trees (the
    ensemble a caller compares predictions with)."""
    import copy
    import dataclasses
    import torch
    from repro_torch.core import (build_tree, build_trees_batched,
                                  predict_bins, walk_class_trees)
    from repro_torch.core.forest import _round_seed, goss_sample_sharded_ref
    lo = model._resolve_loss(labels)
    multi = getattr(lo, "is_multiclass", False)
    y = torch.as_tensor(labels, device=dev,
                        dtype=torch.int64 if multi else torch.float32)
    bins = torch.as_tensor(train.bins, device=dev)
    n_num = torch.as_tensor(train.n_num, device=dev)
    cfg, m = model.config, len(labels)
    q_top, q_oth = model.goss.shard_quota(m, 1)
    base = lo.base_score(y)
    raw = base[:, None].expand(lo.n_classes, m) if multi else base.expand(m)
    gen = torch.Generator().manual_seed(model.seed)
    lr = torch.tensor(model.learning_rate, device=dev)
    trees = []
    for _ in range(model.n_trees):
        g, h = lo.grad_hess(y, raw)
        z = lo.newton_target(g, h)
        rank = torch.sqrt((g * g * h).sum(0)) if multi else g * torch.sqrt(h)
        w = goss_sample_sharded_ref(rank, _round_seed(gen), d_shards=1,
                                    m_valid=m, q_top=q_top, q_oth=q_oth,
                                    device=dev)
        sel = torch.nonzero(w > 0)[:, 0]
        sub = dataclasses.replace(train, bins=bins[sel])
        if multi:
            rt, arrays = build_trees_batched(
                sub, z[:, sel], cfg, sample_weight=w[sel][None] * h[:, sel],
                device=dev)
            trees.extend(rt)
            raw = raw + lr * walk_class_trees(arrays, bins, n_num,
                                              num_steps=cfg.max_depth)
        else:
            tree = build_tree(sub, z[sel], cfg, sample_weight=(w * h)[sel],
                              device=dev)
            trees.append(tree)
            raw = raw + lr * predict_bins(tree, bins, n_num,
                                          num_steps=cfg.max_depth, device=dev)
    out = copy.copy(model)
    out.trees, out._stacked = trees, None
    out.base = (base.cpu().numpy() if multi else float(base))
    out.n_num, out._loss, out._device = np.asarray(train.n_num), lo, dev
    return out


def _selection_mismatches(dev, ens, labels, roots, raws):
    """Rounds whose root selection (``roots``, the level callback's first
    level of each round) differs from ``goss_sample_sharded_ref`` on the
    fit's own leverage: round r ranks the raw scores after round r - 1
    (``raws``, the round callback's), with the fit's round seed."""
    import torch
    from repro_torch.core.forest import _round_seed, goss_sample_sharded_ref
    lo = ens._fitted_loss()
    multi = getattr(lo, "is_multiclass", False)
    y = torch.as_tensor(labels, device=dev,
                        dtype=torch.int64 if multi else torch.float32)
    m = len(labels)
    base = torch.as_tensor(ens.base, device=dev)
    q_top, q_oth = ens.goss.shard_quota(m, 1)
    gen = torch.Generator().manual_seed(ens.seed)
    bad = 0
    for r, root in enumerate(roots):
        raw = (raws[r - 1] if r else
               base[:, None].expand(lo.n_classes, m) if multi
               else base.expand(m))
        g, h = lo.grad_hess(y, raw)
        rank = torch.sqrt((g * g * h).sum(0)) if multi else g * torch.sqrt(h)
        w = goss_sample_sharded_ref(rank, _round_seed(gen), d_shards=1,
                                    m_valid=m, q_top=q_top, q_oth=q_oth,
                                    device=dev)
        bad += not torch.equal(root[:m], w > 0)
    return bad


def _by_tag(counts):
    """Collective [calls, bytes] summed by purpose tag."""
    out = {}
    for (_, tag), (calls, nbytes, _) in counts.items():
        c = out.setdefault(tag, [0, 0])
        c[0] += calls
        c[1] += nbytes
    return out


def _mesh_boosting(dev, mesh, split, model_fn, replay, tmp, resume):
    """One boosted config on the mesh: a checked fit (level and round
    callbacks record each round's selection and raw scores), a timed fit
    that must equal it bit for bit, the selections held against
    ``goss_sample_sharded_ref``, predictions against the local loop fed the
    same draw (``replay``, fitted before the counted window), holdout
    accuracy; with ``resume``, the fit stopped after round 7 and resumed.
    Returns (result line, failures)."""
    import torch
    from repro_torch.checkpoint import RoundCheckpointer
    from repro_torch.core import DistConfig
    train, labels, val_bins, y_val = split
    roots, raws = [], []

    def root(state):
        if state.depth == 2:
            a = state.assign
            roots.append((a if a.dim() == 1 else a[0]) >= 0)

    def fit(**kw):
        t0 = _sync_clock(dev)
        ens = model_fn().fit(train, labels, mesh=mesh, dist=DistConfig(),
                             device=dev, **kw)
        return ens, _sync_clock(dev) - t0

    ens, checked_s = fit(level_callback=root,
                         round_callback=lambda st: raws.append(st.raw))
    again, fit_s = fit()
    failures = []
    same = _same_trees(ens.trees, again.trees)
    bad = _selection_mismatches(dev, ens, labels, roots, raws)
    p_mesh = again.predict_proba_device(val_bins)
    p_loop = replay.predict_proba_device(val_bins)
    diff_nodes = [_differing_nodes(a, b)
                  for a, b in zip(ens.trees, replay.trees)]
    close = torch.allclose(p_mesh, p_loop, rtol=1e-4, atol=1e-4)
    pred = again.predict(val_bins)
    acc = float((pred == y_val).mean())
    base_rate = float(np.bincount(y_val.astype(np.int64)).max() / len(y_val))
    name = again._fitted_loss().name
    line = dict(layout=f"gbt_{name}", rows=len(labels),
                n_trees=len(again.trees), deterministic=same,
                selection_mismatches=bad, rounds_checked=len(roots),
                selected_rows_round0=int(roots[0].sum()),
                pred_max_abs_diff=float((p_mesh - p_loop).abs().max()),
                within_1e4=close, differing_nodes=sum(diff_nodes),
                trees_differing=sum(d > 0 for d in diff_nodes),
                holdout_acc=acc, base_rate=base_rate,
                fit_s=fit_s, checked_fit_s=checked_s,
                collectives_by_tag=_by_tag(again.collective_counts),
                collective_host_s=sum(v[2] for v in
                                      again.collective_counts.values()))
    need(same, f"dist {name}: two mesh fits grew different trees")
    if bad or len(roots) != again.n_trees:
        failures.append(f"dist {name}: {bad} of {len(roots)} rounds' "
                        "selections differ from goss_sample_sharded_ref")
    if not close:
        failures.append(f"dist {name}: predictions beyond rtol/atol 1e-4 of "
                        "the local loop fed the same draw")
    if acc <= base_rate:
        failures.append(f"dist {name}: holdout accuracy {acc} <= base rate "
                        f"{base_rate}")
    if resume:
        d = f"{tmp}/mesh_{name}"
        try:
            fit(round_callback=_interrupted(RoundCheckpointer(d, every=7), 7))
            failures.append(f"dist {name}: the fit was not interrupted")
        except _Interrupt:
            resumed, resumed_s = fit(resume_from=d)
            same = (_same_trees(again.trees, resumed.trees)
                    and np.array_equal(again.predict_raw(val_bins),
                                       resumed.predict_raw(val_bins)))
            line["resume"] = dict(interrupted_after_round=7,
                                  bit_identical=same, resumed_fit_s=resumed_s)
            if not same:
                failures.append(f"dist {name}: the resumed mesh fit differs "
                                "from the uninterrupted one")
    return line, failures


def phase_dist(dev, table, y, smi, kdd_tree, forest_rf, local_fit_s):
    """The sharded build (``core.distributed``) on a 1-rank NCCL group with
    a 1x1 ("data", "model") ``DeviceMesh``: every collective is called, on
    one card.  (a) The paper config's KDD99 build under ``DistConfig()``
    (slot scatter composed with subtraction), ``slot_scatter=False`` and
    ``model_axis=None`` equals phase 4's local kernel tree bit for bit;
    each chunk's histogram collective hands in the bytes of the
    reference's per-chunk arithmetic.  (b) ``build_batched`` on a softmax
    round (5 class targets, GOSS weights) against ``build_trees_batched``:
    predictions within rtol/atol 1e-4, differing nodes counted.  (c) The
    sharded boosting loop, ``fit(mesh=, dist=DistConfig())``, on phase
    gbt's and phase softmax's configs: two fits bit-identical, every
    round's selection equal to ``goss_sample_sharded_ref``'s, predictions
    within rtol/atol 1e-4 of the local loop fed the same draw (differing
    nodes counted), holdout accuracy above the base rate; the logistic fit
    stopped after round 7 and resumed bit for bit.  (d) Phase forest's
    config on the mesh: its trees.  (e) Phase 4's tree swept on the mesh:
    the local card sweep's grid, configs/s.  (f) Kernel A's weights,
    slot_map and stacked modes and kernel B launched by the sharded path,
    the fused epilogue not; collective calls and bytes by tag, sharded and
    local seconds."""
    import tempfile
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import (DistConfig, DistributedBuilder, SweepSpace,
                                  build_tree, build_trees_batched, get_loss,
                                  predict_bins, sweep)
    from repro_torch.core.collectives import Collectives
    from repro_torch.core.distributed import sharded_grid_counts
    from repro_torch.kernels import ops
    train, y_tr, val_bins, y_val = _split_rows(table, y, seed=0)
    split_b = _split_rows(table, (y != 0).astype(np.float32), seed=0)
    cfg = _paper_config()

    def twice(build):
        """(result, [first, second] synchronised seconds); the two results
        must be equal.  The first sharded build of a group also sets up
        its NCCL communicators."""
        out, secs = [], []
        for _ in range(2):
            t0 = _sync_clock(dev)
            out.append(build())
            secs.append(_sync_clock(dev) - t0)
        a, b = ([t] if hasattr(t, "n_nodes") else t[0] for t in out)
        need(_same_trees(a, b), "two equal builds gave different trees")
        return out[0], secs

    # the local builds first: their launches are not the phase's
    local, local_s = twice(lambda: build_tree(train, y_tr, cfg,
                                              n_classes=N_CLASS, device=dev))
    need(not _differing(local, kdd_tree), "a second local kdd99 build "
         "differs from phase 4's")
    model = _softmax_model(1)
    sub, z, w = _softmax_round0(dev, get_loss("softmax", n_classes=N_CLASS),
                                model.goss, train, y_tr)
    (want, _), local_batched_s = twice(lambda: build_trees_batched(
        sub, z, model.config, sample_weight=w, device=dev))
    # the local loops fed the sharded draw, and the local sweep
    replays = {"gbt": _sharded_replay(dev, _logistic_model(20),
                                           split_b[0], split_b[1]),
               "softmax": _sharded_replay(dev, _softmax_model(20), train,
                                          y_tr)}
    space = SweepSpace(mcw_values=(0.0, 1.0, 5.0, 25.0))

    def swept(**kw):
        t0 = _sync_clock(dev)
        res = sweep(kdd_tree, val_bins, y_val, train.n_num, space=space,
                    train_size=len(y_tr), device=dev, **kw)
        return res, _sync_clock(dev) - t0

    local_sweep, local_sweep_s = swept()
    lines, failures = [], []
    on_card = dev.type == "cuda"            # gloo only in a CPU rehearsal
    with tempfile.TemporaryDirectory() as tmp:
        if on_card:
            torch.cuda.set_device(0 if dev.index is None else dev.index)
        tdist.init_process_group("nccl" if on_card else "gloo",
                                 init_method=f"file://{tmp}/store", rank=0,
                                 world_size=1)
        try:
            mesh = init_device_mesh(dev.type, (1, 1),
                                    mesh_dim_names=("data", "model"))
            ops.reset_launch_counts()
            built = []
            for name, kw in DIST_LAYOUTS:
                builder = DistributedBuilder(train, cfg, mesh=mesh,
                                             dist=DistConfig(**kw),
                                             n_classes=N_CLASS, device=dev)
                builder.comm.log = []
                tree, secs = twice(lambda: builder.build(y_tr))
                built.append((name, tree, secs, _per_build(builder),
                              _hist_per_chunk(builder,
                                              N_FEAT * 257 * N_CLASS * 4)))
            builder = DistributedBuilder(sub, model.config, mesh=mesh,
                                         device=dev)
            (got, _), batched_s = twice(
                lambda: builder.build_batched(z, sample_weight=w))
            batched_counts = _per_build(builder)
            boosted = []
            for key, split, make, resume in (
                    ("gbt", split_b, lambda: _logistic_model(20), True),
                    ("softmax", (train, y_tr, val_bins, y_val),
                     lambda: _softmax_model(20), False)):
                line, bad = _mesh_boosting(dev, mesh, split, make,
                                           replays[key], tmp, resume)
                line["local_fit_s"] = local_fit_s[key]
                boosted.append(line)
                failures += bad
            t0 = _sync_clock(dev)
            rf = _forest_model().fit(train, y_tr, mesh=mesh,
                                     dist=DistConfig(), device=dev)
            forest_s = _sync_clock(dev) - t0
            mesh_sweep, mesh_sweep_s = swept(mesh=mesh, dist=DistConfig())
            comm = Collectives(mesh)
            sharded_grid_counts(mesh, DistConfig(), kdd_tree, val_bins, y_val,
                                train.n_num, mesh_sweep.smin, mesh_sweep.mcw,
                                mesh_sweep.dmax, device=dev, comm=comm)
            launches = ops.launch_counts()
        finally:
            tdist.destroy_process_group()
    for name, tree, secs, counts, per_chunk in built:
        diff = _differing(tree, kdd_tree)
        hist_op = "all_reduce" if name == "psum_sub" else "reduce_scatter_tensor"
        calls, nbytes, _ = counts.get((hist_op, "hist"), (0, 0, 0.0))
        ref_chunks, ref_bytes, bad = per_chunk
        line = dict(layout=name, n_nodes=tree.n_nodes, differing=diff,
                    build_s=secs, local_build_s=local_s,
                    collective_calls=sum(v[0] for v in counts.values()),
                    collective_bytes=sum(v[1] for v in counts.values()),
                    collective_host_s=sum(v[2] for v in counts.values()),
                    hist_collective=dict(op=hist_op, calls=calls,
                                         bytes=nbytes, chunks=ref_chunks,
                                         reference_bytes=ref_bytes,
                                         differing_calls=bad),
                    collectives={f"{op}/{tag}": v
                                 for (op, tag), v in sorted(counts.items())},
                    card=smi)
        say("  dist", json.dumps(line))
        lines.append(line)
        if diff:
            failures.append(f"dist {name}: differs from phase 4's tree in "
                            f"{diff}")
        if bad or (calls, nbytes) != (ref_chunks, ref_bytes):
            failures.append(f"dist {name}: {calls} {hist_op} calls / {nbytes}"
                            f" bytes over {ref_chunks} chunks, {bad} calls "
                            f"off the reference's arithmetic ({ref_bytes} "
                            f"bytes)")
    sub_bins = torch.as_tensor(sub.bins, device=dev)
    pred_err, diff_nodes = [], []
    for g, wt in zip(got, want):
        p_got = predict_bins(g, sub_bins, sub.n_num, device=dev)
        p_want = predict_bins(wt, sub_bins, sub.n_num, device=dev)
        pred_err.append(float((p_got - p_want).abs().max()))
        diff_nodes.append(_differing_nodes(g, wt))
        if not torch.allclose(p_got, p_want, rtol=1e-4, atol=1e-4):
            failures.append("dist batched: predictions beyond rtol/atol 1e-4")
    line = dict(layout="batched", rows=int(z.shape[1]), classes=int(z.shape[0]),
                n_nodes=[t.n_nodes for t in got],
                local_n_nodes=[t.n_nodes for t in want],
                differing_nodes=diff_nodes,
                identical=[not _differing(g, wt) for g, wt in zip(got, want)],
                pred_max_abs_diff=pred_err, build_s=batched_s,
                local_build_s=local_batched_s,
                collective_host_s=sum(v[2] for v in batched_counts.values()),
                collectives={f"{op}/{tag}": v
                             for (op, tag), v in sorted(batched_counts.items())},
                launches=launches, card=smi)
    say("  dist", json.dumps(line))
    for line in boosted:
        line["card"] = smi
        say("  dist", json.dumps(line))
    forest_same = _same_trees(rf.trees, forest_rf.trees)
    say("  dist", json.dumps(dict(
        layout="forest", n_trees=len(rf.trees), identical=forest_same,
        fit_s=forest_s, local_fit_s=local_fit_s["forest"], card=smi)))
    if not forest_same:
        failures.append("dist forest: the mesh forest's trees differ from "
                        "phase forest's")
    grid_same = all(np.array_equal(getattr(mesh_sweep, f),
                                   getattr(local_sweep, f))
                    for f in ("metric", "n_nodes", "walk_bytes"))
    grid_same &= (mesh_sweep.front == local_sweep.front
                  and mesh_sweep.best == local_sweep.best)
    say("  dist", json.dumps(dict(
        layout="sweep", configs=int(mesh_sweep.n_configs),
        grid=list(mesh_sweep.metric.shape), equal_to_local=grid_same,
        sweep_s=mesh_sweep_s, local_sweep_s=local_sweep_s,
        configs_per_s=mesh_sweep.n_configs / mesh_sweep_s,
        local_configs_per_s=local_sweep.n_configs / local_sweep_s,
        grid_collectives=_by_tag(comm.counts).get("grid"), card=smi)))
    if not grid_same:
        failures.append("dist sweep: the mesh grid differs from the local "
                        "card sweep's")
    need(not failures, "; ".join(failures))
    for name in ("histogram", "histogram_weights", "histogram_slot_map",
                 "histogram_stacked", "split_scan"):
        need(launches[name] > 0, f"the dist phase never launched {name}")
    need(launches["histogram_fused"] == 0, "a sharded build with data axes "
         "took the fused epilogue")
    return launches


# ---------------------------------------------------------------------------
# phase check: the contract gate (repro_torch.check) on the card
# ---------------------------------------------------------------------------

def _check_surface(name, surface):
    """The rules of contract ``name`` on ``surface``; fails on a violation."""
    from repro_torch.check.contracts import registry
    from repro_torch.check.rules import run_rules
    viol = run_rules(registry()[name].rules, surface)
    need(not viol, f"check {name} ({surface.label}): "
         + "; ".join(map(str, viol)))


def _full_width(widest, widest_rv):
    """``core/chunk-step``, ``core/chunk-step-kernel`` and
    ``core/chunk-step-batched`` recorded again at the main path's widths
    (KDD99: M = 494,021, K = 41, B = 257, C = 5 at S = 16 and the widest
    chunk; a softmax round: 5 x 177,848 rows, C' = 3, at S = 16 and its
    widest chunk), each under its contract's rules.  Returns the
    surfaces."""
    from repro_torch.check import contracts as con
    from repro_torch.check.recorder import record
    from repro_torch.core.tree import _chunk_step, _chunk_step_classes
    rng = np.random.default_rng(0)
    out = []
    for s in (16, widest):
        nodes = 4 * s + 64
        args = con.chunk_step_args(rng, m=M_ROWS, k=N_FEAT, b=257, c=N_CLASS,
                                   s=s, max_nodes=nodes)
        for name, backend in (("core/chunk-step", "segment"),
                              ("core/chunk-step-kernel", "kernel")):
            kw = con.chunk_step_kw(num_slots=s, n_bins=257, max_nodes=nodes,
                                   hist_backend=backend)
            surf = record(lambda *a: _chunk_step(*a, **kw), *args,
                          device="cuda", label=f"{name} S={s}")
            _check_surface(name, surf)
            out.append(surf)
    for s in (16, widest_rv):
        nodes = 4 * s + 64
        kw = con.batched_step_kw(num_slots=s, n_bins=257, max_nodes=nodes)
        surf = record(lambda *a: _chunk_step_classes(*a, **kw),
                      *con.batched_step_args(rng, n_cls=N_CLASS,
                                             m=SOFTMAX_ROWS, k=N_FEAT, b=257,
                                             s=s, nodes=nodes),
                      device="cuda", label=f"core/chunk-step-batched S={s}")
        _check_surface("core/chunk-step-batched", surf)
        out.append(surf)
    return out


def _scan_surfaces(dev):
    """The linear scan's two ops recorded at SCAN_SHAPES (forward, then the
    backward on its output), each under ``KernelBudget`` with its kernel
    required: every launch's plan bytes against the card's opt-in limit.
    Returns the surfaces."""
    import torch
    from repro_torch.check.recorder import record
    from repro_torch.check.rules import KernelBudget, run_rules
    ops = torch.ops.repro_torch
    out = []
    for shape in SCAN_SHAPES:
        a, b, gy, _ = _scan_operands(shape, dev)
        surf = record(lambda a, b, g: ops.linear_scan_backward(
            a, ops.linear_scan(a, b), g), a, b, gy, device="cuda",
            label=f"linear_scan {list(shape)}")
        viol = run_rules((KernelBudget(require_kernel="linear_scan"),
                          KernelBudget(require_kernel="linear_scan_backward")),
                         surf)
        need(not viol, f"check {surf.label}: " + "; ".join(map(str, viol)))
        out.append(surf)
        del a, b, gy
    return out


def _mutations():
    """The two seeded mutations, in process: the grid's psum rerouted
    through an all-gather, and a ``.tolist()`` inside the routed walk.
    Each must make its contract fail.  Returns {mutation: why it failed}."""
    from repro_torch.check.cli import run_contracts
    from repro_torch.core.collectives import Collectives
    from repro_torch.serve import registry as reg

    def evil_psum(self, x, axes, tag):
        return self.all_gather(x[None], axes, tag).sum(0)

    real_pred = reg.evaluate_predicate

    def evil_pred(xb, nn, op, tbin):
        xb.tolist()
        return real_pred(xb, nn, op, tbin)

    flips = {}
    for label, (owner, attr, evil), only in (
            ("psum->all_gather", (Collectives, "psum", evil_psum),
             "dist/grid-counts"),
            ("tolist in walk", (reg, "evaluate_predicate", evil_pred),
             "serve/routed-walk")):
        real = getattr(owner, attr)
        setattr(owner, attr, evil)
        try:
            results, n_fail = run_contracts(only=only, device="cuda")
        finally:
            setattr(owner, attr, real)
        (_, viol, error, _, _), = results
        need(n_fail == 1, f"check: mutation {label} did not flip {only}")
        flips[label] = ("trace error: " + error.strip().splitlines()[-1]
                        if error else "; ".join(map(str, viol)))
    return flips


def phase_check(dev, widest, widest_rv, smi):
    """The contract gate on the card: the eleven contracts recorded under
    ``set_sync_debug_mode("error")`` (every one must hold), the three
    level-step contracts at full width, the linear scan's ops at
    SCAN_SHAPES, every kernel launch's shared memory against the card's
    opt-in limit, and both seeded mutations flipping their contracts."""
    import torch
    from repro_torch.check.cli import run_contracts
    from repro_torch.kernels import ops
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    ops.reset_launch_counts()
    t0 = _sync_clock(dev)
    results, n_fail = run_contracts(device="cuda")
    full = _full_width(widest, widest_rv) + _scan_surfaces(dev)
    check_s = _sync_clock(dev) - t0
    launches = ops.launch_counts()
    for con, viol, error, _, _ in results:
        if viol or error:
            say(f"  check {con.name}: " + (error or "; ".join(map(str, viol))))
    need(n_fail == 0, f"check: {n_fail} of {len(results)} contracts failed "
         "on the card")
    smem = []
    for surf in [s for _, _, _, _, s in results] + full:
        for lc in surf.launches:
            smem.append(dict(surface=surf.label, kernel=lc.kernel,
                             modes=list(lc.modes), smem=lc.smem))
            say(f"  check launch {surf.label}: {lc.kernel} "
                f"{'/'.join(lc.modes)} shared memory {lc.smem} B of "
                f"{optin} B opt-in")
    kernel_hist = [d for d in smem if d["kernel"] == "histogram"
                   and d["surface"].startswith("core/chunk-step-kernel")]
    need(any(d["surface"] == "core/chunk-step-kernel" for d in kernel_hist)
         and any("S=" in d["surface"] for d in kernel_hist),
         "check: no histogram launch recorded at the smoke shapes and at "
         "full width")
    need(all(d["smem"] is not None and d["smem"] <= optin for d in smem),
         f"check: a launch's shared memory is unknown or above {optin} B")
    t1 = _sync_clock(dev)
    flips = _mutations()
    mutation_s = _sync_clock(dev) - t1
    say("  check", json.dumps(dict(
        contracts={con.name: "pass" for con, *_ in results},
        full_width=[s.label for s in full], optin_smem=optin,
        launches_smem=smem, mutations=flips, check_s=check_s,
        mutation_s=mutation_s, launches=launches, card=smi)))
    need(launches["histogram_fused"] > 0, "the check phase never launched "
         "the fused histogram")
    return launches


# ---------------------------------------------------------------------------
# phase lm: the LM serving path (models/, serve.serve, launch.serve)
# ---------------------------------------------------------------------------

def _tree_launches(launches):
    """The launches of the tree kernels (the histogram and the split scan)
    among ``ops.launch_counts()``'s."""
    return {k: v for k, v in launches.items()
            if v and not k.startswith("linear_scan")}


# the full-width models: the launcher's default, then the two that run the
# rglru and the mlstm / slstm blocks at a published width
LM_FULL = ("smollm-360m", "recurrentgemma-2b", "xlstm-125m")
LM_TOKENS: dict = {}      # arch -> phase lm's greedy tokens (host)
LM_TOL = 5e-2            # tests/test_recurrences.py's decode-vs-forward bound
LM_CARD_VS_CPU = 1e-3


def _decode_vs_forward(model, dev, t=12, b=2):
    """{dtype: (max |decode - teacher-forced forward|, logits outside rtol =
    atol = LM_TOL)} over a seeded [b, t] batch, with f32 activations and at
    the config's own bf16, on the same weights.  Only the f32 run is held
    to LM_TOL: at 26-32 layers of bf16 the reference's own decode leaves
    its forward by more (tests/test_torch_lm_depth.py)."""
    import dataclasses
    import torch
    from repro_torch.models import model as M
    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab, (b, t), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    out = {}
    try:
        for dtype in ("float32", cfg.dtype):
            model.cfg = dataclasses.replace(cfg, dtype=dtype)
            with torch.no_grad():
                full = M.forward(model, {"tokens": toks}).float()
            cache = M.init_cache(cfg, b, t + 1, dev)
            outs = []
            for s in range(t):
                lg, cache = M.decode_step(model, toks[:, s:s + 1], cache)
                outs.append(lg.float())
            err = (torch.cat(outs, dim=1) - full).abs()
            out[dtype] = (float(err.max()),
                          int((err > LM_TOL + LM_TOL * full.abs()).sum()))
    finally:
        model.cfg = cfg
    return out


def _profiled_decode(model, prompt, dev, steps=8):
    """``steps`` decode steps (a prefill of that many prompt tokens) under
    torch.profiler: device ops and the device's busy time a step (the
    union of its op spans), and the profiled wall time a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import serve as S
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S.prefill(model, prompt[:, :steps], steps + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    return dict(steps=steps, device_ops_per_step=len(spans) / steps,
                device_busy_ms_per_step=_union_us(spans) / 1e3 / steps,
                profiled_wall_ms_per_step=wall * 1e3 / steps)


def _lm_full_width(arch, dev, smi):
    """One full-width model through the launcher's own function (defaults:
    batch 4, prompt 16, 32 greedy tokens), then prefill and the decode loop
    again under set_sync_debug_mode("error"), timed with CUDA events, and
    decode against teacher-forced forward at T = 12."""
    import torch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import serve as S
    t_model = time.perf_counter()
    args = launch_serve.build_parser().parse_args(["--arch", arch])
    torch.cuda.reset_peak_memory_stats(dev)
    res = launch_serve.serve_lm(args, dev)
    model, prompt, toks = res["model"], res["prompt"], res["tokens"]
    cfg = model.cfg
    need(tuple(toks.shape) == (args.batch, args.gen)
         and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
         f"lm {arch}: tokens {tuple(toks.shape)} out of range")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev[0].record()
        logits, cache = S.prefill(model, prompt, args.prompt_len + args.gen + 1)
        ev[1].record()
        again, cache = S.decode_loop(model, logits, cache, args.gen)
        ev[2].record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
    index = int(cache["index"])
    need(index == args.prompt_len + args.gen,
         f"lm {arch}: cache index {index}, not {args.prompt_len + args.gen}")
    LM_TOKENS[arch] = toks            # phase mesh holds its run to these
    prefill_s = ev[0].elapsed_time(ev[1]) / 1e3
    decode_s = ev[1].elapsed_time(ev[2]) / 1e3
    dvf = _decode_vs_forward(model, dev)
    prof = _profiled_decode(model, prompt, dev)
    step_ms = decode_s * 1e3 / args.gen
    prof["decode_ms_per_step"] = step_ms
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms_per_step"] / step_ms
    stats = dict(
        lm=arch, params=sum(p.numel() for p in model.parameters()),
        batch=args.batch, prompt=args.prompt_len, gen=args.gen,
        init_s=res["init_s"], launcher_s=res["seconds"],
        prefill_s=prefill_s, decode_s=decode_s,
        decode_tok_s=args.batch * args.gen / decode_s,
        tok_s=args.batch * args.gen / (prefill_s + decode_s),
        cache_index=index, same_tokens=bool(torch.equal(again.cpu(), toks)),
        decode_vs_forward={k: dict(max_abs=v[0], outside=v[1])
                           for k, v in dvf.items()},
        profile=prof, peak_bytes=torch.cuda.max_memory_allocated(dev),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        model_s=time.perf_counter() - t_model, card=smi)
    say("  lm", json.dumps(stats))
    need(dvf["float32"][1] == 0, f"lm {arch}: with f32 activations decode "
         f"differs from forward at {dvf['float32'][1]} logits "
         f"(max {dvf['float32'][0]})")
    del res, model, prompt, cache, logits
    torch.cuda.empty_cache()
    return stats


def _lm_card_vs_cpu(arch, dev):
    """A smoke config in f32: the same seeded weights on the CPU and moved
    to the card; max |card - cpu| over forward and, where the arch decodes,
    three decode steps."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    rng = np.random.default_rng(3)
    batch = {}
    if cfg.frontend == "audio_frames":
        batch["frames"] = rng.normal(size=(2, 16, cfg.frontend_dim))
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, size=(2, 16))
    if cfg.frontend == "vision_patches":
        batch["patches"] = rng.normal(size=(2, cfg.n_prefix, cfg.frontend_dim))
    steps = rng.integers(0, cfg.vocab, size=(2, 3))
    outs = {}
    for where in ("cpu", "card"):
        d = dev if where == "card" else torch.device("cpu")
        model = M.init_params(cfg, torch.Generator().manual_seed(0),
                              "cpu").to(d)
        b = {k: torch.as_tensor(v, device=d, dtype=torch.float32
                                if v.dtype.kind == "f" else torch.int32)
             for k, v in batch.items()}
        with torch.no_grad():
            got = [M.forward(model, b).float().cpu()]
        if cfg.supports_decode:
            cache = M.init_cache(cfg, 2, 8, d)
            for s in range(3):
                tok = torch.as_tensor(steps[:, s:s + 1], dtype=torch.int32,
                                      device=d)
                lg, cache = M.decode_step(model, tok, cache)
                got.append(lg.float().cpu())
        outs[where] = got
    return max(float((a - b).abs().max())
               for a, b in zip(outs["card"], outs["cpu"]))


def phase_lm(dev, smi):
    """The LM serving path on the card: smollm-360m, recurrentgemma-2b and
    xlstm-125m at full width through the launcher's own function; the ten
    smoke archs in f32 on the card against the port's own CPU result; the
    launcher's --forest mode once.  The RG-LRU and the sLSTM launch the
    linear scan; the LM path launches no tree kernel, and neither do the
    forest mode's fits (the launcher's TreeConfig keeps the default
    backends, as the reference's does)."""
    import argparse
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    need(not torch.backends.cuda.matmul.allow_tf32,
         "lm: torch.backends.cuda.matmul.allow_tf32 is on")
    say(f"  matmul allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    ops.reset_launch_counts()
    t0 = _sync_clock(dev)
    full = [_lm_full_width(arch, dev, smi) for arch in LM_FULL]
    t1 = _sync_clock(dev)
    card_vs_cpu = {arch: _lm_card_vs_cpu(arch, dev)
                   for arch in configs.ARCH_IDS}
    t2 = _sync_clock(dev)
    lm_launches = ops.launch_counts()
    need(not _tree_launches(lm_launches),
         f"lm: the LM path launched a tree kernel: {lm_launches}")
    need(lm_launches["linear_scan"] > 0,
         f"lm: the RG-LRU / sLSTM launched no linear scan: {lm_launches}")
    forest = launch_serve.serve_forest(
        argparse.Namespace(tenants=3, requests=50), dev)
    t3 = _sync_clock(dev)
    launches = ops.launch_counts()
    lat = np.asarray(forest["latency_s"]) * 1e3
    say("  lm", json.dumps(dict(
        card_vs_cpu_max_abs=card_vs_cpu, tolerance=LM_CARD_VS_CPU,
        forest=dict(tenants=3, requests=50,
                    p50_ms=float(np.percentile(lat, 50)),
                    p99_ms=float(np.percentile(lat, 99)),
                    executables=forest["executables"], cost=forest["cost"]),
        full_width_s=t1 - t0, card_vs_cpu_s=t2 - t1, forest_s=t3 - t2,
        peak_bytes=max(f["peak_bytes"] for f in full),
        lm_launches=lm_launches, launches=launches, card=smi)))
    bad = {a: e for a, e in card_vs_cpu.items() if not e <= LM_CARD_VS_CPU}
    need(not bad, f"lm: card against CPU beyond {LM_CARD_VS_CPU}: {bad}")
    return launches


# ---------------------------------------------------------------------------
# phase train: LM training (train/, launch.train, the train-state checkpoint)
# ---------------------------------------------------------------------------

# (arch, steps through the launcher): the launcher's default, then the two
# that run RG-LRU and mLSTM / sLSTM under autograd at a published width
TRAIN_FULL = (("smollm-360m", 8), ("recurrentgemma-2b", 3),
              ("xlstm-125m", 3))
TRAIN_CARD_VS_CPU = 1e-4
# a resumed run against the straight one: bit for bit (the embedding's
# gradient and the MoE combine add repeated rows in one fixed order, F2)
TRAIN_RESUME_TOL = 0.0


def _state_diff(a, b):
    """max |a - b| over the parameters and both moments of two states."""
    import torch
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    with torch.no_grad():
        diffs = [(pa[n] - pb[n]).abs().max() for n in pa]
        for k in ("m", "v"):
            diffs += [(a.opt[k][n].float() - b.opt[k][n].float()).abs().max()
                      for n in pa]
        return float(torch.stack(diffs).max())


def _nondeterministic_grads(model, batch):
    """The parameters whose gradients differ between two backward passes of
    the same loss on the same inputs: where the card's step is not
    deterministic (float atomics add in any order)."""
    from repro_torch.train import train_step as T
    chunk = 512 if model.cfg.vocab >= 32_768 else 0     # the step's own
    _, a = T.loss_and_grads(model, batch, loss_chunk=chunk)
    _, b = T.loss_and_grads(model, batch, loss_chunk=chunk)
    return sorted(n for n in a if not bool((a[n] == b[n]).all()))


def _new_params_err(p0, p_ref, p_got, lr, tol, wd=0.1):
    """One step's new parameters against a reference step (numpy trees of
    leaves): (max |diff| where the reference's Adam direction |u| >= 0.99,
    max |diff| anywhere, elements beyond ``tol`` where |u| < 0.99).  Where
    the gradient sits at its own rounding noise (|g| ~ eps = 1e-8) the
    direction g / (|g| + eps) is ill-conditioned and may differ by up to
    2 in the two runs; tests/test_torch_train.py explains the split."""
    well_err = any_err = 0.0
    noisy = 0
    for a, r, q in zip(p0, p_ref, p_got):
        u = (a - r) / lr - wd * a
        well = np.abs(u) >= 0.99
        d = np.abs(q - r)
        if well.any():
            well_err = max(well_err, float(d[well].max()))
        any_err = max(any_err, float(d.max()))
        noisy += int((d[~well] > tol).sum())
    return well_err, any_err, noisy


def _train_card_vs_cpu(arch, dev):
    """A smoke config in f32: one launcher-default train step (lr 3e-4) on
    the CPU and on the card from the same seeded weights and batch; the
    loss, grad-norm and new-parameter gaps, and how many values of the
    xLSTM normaliser max(|n|, 1) fell on different sides of its kink in
    the two runs (a flip changes that value's gradient from 0 to -1/n**2:
    the gradients are then not comparable, the loss still is)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.models import xlstm as XL
    from repro_torch.train import init_train_state, make_train_step
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    tree = M.train_state_to_numpy(init_train_state(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    batch = launch_train.synthetic_lm_batch(cfg, 2, 16, 0, device="cpu")
    out, seen, normalizer = {}, {}, XL._normalizer
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        seen[where] = rec = []
        XL._normalizer = lambda n, rec=rec: (rec.append(n.detach().cpu()),
                                             normalizer(n))[1]
        try:
            state = M.train_state_from_numpy(tree, cfg, d)
            state, m = make_train_step(cfg)(
                state, {k: v.to(d) for k, v in batch.items()})
        finally:
            XL._normalizer = normalizer
        out[where] = (float(m["loss"]), float(m["grad_norm"]),
                      [np.asarray(x, np.float32) for x in
                       _leaves(M.params_to_numpy(state.model))])
    p0 = [np.asarray(x, np.float32) for x in _leaves(tree["params"])]
    well, worst, noisy = _new_params_err(p0, out["cpu"][2], out["card"][2],
                                         3e-4, TRAIN_CARD_VS_CPU)
    flips = sum(int(((a.abs() >= 1) != (b.abs() >= 1)).sum())
                for a, b in zip(seen["cpu"], seen["card"]))
    rel = lambda i: abs(out["card"][i] - out["cpu"][i]) / abs(out["cpu"][i])  # noqa: E731
    return dict(loss_rel=rel(0), grad_norm_rel=rel(1), params_max_abs=well,
                params_max_abs_anywhere=worst, ill_conditioned_beyond=noisy,
                normalizer_flips=flips)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _param_sums(model):
    import torch
    return torch.stack([p.detach().double().sum()
                        for p in model.parameters()])


def _profiled_steps(step_fn, state, batch, steps=2):
    """``steps`` train steps under torch.profiler (device activity only: a
    step issues thousands of ops): device ops, the device's busy time a
    step (the union of its op spans) and the device time of the csrc
    kernels (the linear scan) a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, ours = [], 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        key = ev.name.split("(anonymous namespace)::", 1)[-1].split("(")[0]
        if key.split("<")[0] in KERNEL_FUNCTIONS:
            ours += (ev.time_range.end - ev.time_range.start) / 1e3
    return dict(steps=steps, device_ops_per_step=len(spans) / steps,
                device_busy_ms_per_step=_union_us(spans) / 1e3 / steps,
                csrc_kernel_ms_per_step=ours / steps,
                profiled_wall_ms_per_step=wall * 1e3 / steps)


def _adamw_times(state, lr):
    """The port's adamw_update and torch.optim.AdamW(fused=True), the
    yardstick, on the model's own parameters with seeded gradients (CUDA
    events, mean of 3 after a warm-up; the fused optimizer's moments are
    its own).  The bound: 28 bytes a parameter (p, g, m, v read; p, m, v
    written) at the card's memory rate."""
    import torch
    from repro_torch.train import optimizer as O
    params = dict(state.model.named_parameters())
    g = torch.Generator(device=state.model.device).manual_seed(11)
    grads = {n: torch.randn(p.shape, generator=g, device=p.device) * 1e-3
             for n, p in params.items()}
    port_ms = cuda_ms(lambda: O.adamw_update(grads, state.opt, params,
                                             lr=lr), reps=3, warmup=1)
    state.opt["m"].clear()          # room for the fused optimizer's own
    state.opt["v"].clear()
    for n, p in params.items():
        p.grad = grads[n]
    fused = torch.optim.AdamW(list(params.values()), lr=lr,
                              betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                              fused=True)
    fused_ms = cuda_ms(fused.step, reps=3, warmup=1)
    n = sum(p.numel() for p in params.values())
    for p in params.values():
        p.grad = None
    del fused, grads
    return dict(adamw_ms=port_ms, fused_adamw_ms=fused_ms,
                adamw_bound_ms=bound(28 * n, 0)[0])


def _train_full_width(arch, steps, dev, smi, tmp):
    """One full-width model through the launcher's own function (batch 8,
    seq 128, lr 3e-4, remat as configured); for smollm-360m with
    checkpoints every 4 steps under ``tmp``, a fresh run resumed from step
    4 against the straight one, and 8 steps on one fixed batch.  Then a
    step under set_sync_debug_mode("error"), timed steps, a profile, and
    the port's AdamW beside the fused one."""
    import os
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.train import init_train_state, make_train_step
    t_model = time.perf_counter()
    resume = arch == "smollm-360m"
    straight_dir = os.path.join(tmp, f"{arch}-straight")
    argv = ["--arch", arch, "--steps", str(steps), "--ckpt-every", "4"]
    args = launch_train.build_parser().parse_args(
        argv + (["--ckpt-dir", straight_dir] if resume else []))
    cfg = configs.get(arch)
    init = _param_sums(M.init_params(   # the launcher's seeded init
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    torch.cuda.reset_peak_memory_stats(dev)
    res = launch_train.train_lm(args, dev)
    state = res["state"]
    losses = [float(m["loss"]) for m in res["metrics"]]
    gnorms = [float(m["grad_norm"]) for m in res["metrics"]]
    moved = int((_param_sums(state.model) != init).sum())
    n_tensors = len(list(state.model.parameters()))
    stats = dict(train=arch, params=sum(p.numel()
                                        for p in state.model.parameters()),
                 batch=args.batch, seq=args.seq, lr=args.lr,
                 remat=cfg.remat, remat_policy=cfg.remat_policy,
                 steps=steps, losses=losses, grad_norms=gnorms,
                 tensors_moved=moved, tensors=n_tensors,
                 launcher_s=res["seconds"])
    need(all(np.isfinite(losses + gnorms)),
         f"train {arch}: a loss or grad norm is not finite")
    need(moved == n_tensors, f"train {arch}: {n_tensors - moved} parameter "
         "tensors did not move")
    step_fn = make_train_step(cfg, lr=args.lr)
    batch = launch_train.synthetic_lm_batch(cfg, args.batch, args.seq, steps,
                                            device=dev)
    if resume:
        resumed_dir = os.path.join(tmp, f"{arch}-resumed")
        os.makedirs(resumed_dir)
        os.rename(os.path.join(straight_dir, "step_00000004"),
                  os.path.join(resumed_dir, "step_00000004"))
        shutil.rmtree(straight_dir)
        again = launch_train.train_lm(launch_train.build_parser().parse_args(
            argv + ["--ckpt-dir", resumed_dir]), dev)
        shutil.rmtree(resumed_dir)
        diff = _state_diff(state, again["state"])
        resumed_losses = [float(m["loss"]) for m in again["metrics"]]
        stats["resume"] = dict(
            start=again["start"], losses=resumed_losses,
            bit_equal=diff == 0.0, max_abs=diff, tolerance=TRAIN_RESUME_TOL,
            grads_differing_run_to_run=_nondeterministic_grads(
                state.model, batch))
        need(again["start"] == 4, f"train {arch}: resumed at "
             f"{again['start']}, not 4")
        need(diff <= TRAIN_RESUME_TOL, f"train {arch}: the resumed run "
             f"ends {diff} from the straight run")
        del again
        fixed = init_train_state(cfg, torch.Generator(device=dev)
                                 .manual_seed(0), dev)
        b0 = launch_train.synthetic_lm_batch(cfg, args.batch, args.seq, 0,
                                             device=dev)
        fixed_losses = []
        for _ in range(8):
            fixed, m = step_fn(fixed, b0)
            fixed_losses.append(m["loss"])
        fixed_losses = [float(x) for x in fixed_losses]
        stats["fixed_batch_losses"] = fixed_losses
        need(fixed_losses[-1] < fixed_losses[0], f"train {arch}: 8 steps on "
             f"one batch did not lower the loss: {fixed_losses}")
        del fixed, b0
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_fn(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    stats["sync_debug_step"] = "no host sync"
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    timed = 3 if arch != "recurrentgemma-2b" else 2
    ev[0].record()
    for _ in range(timed):
        step_fn(state, batch)
    ev[1].record()
    ev[1].synchronize()
    step_ms = ev[0].elapsed_time(ev[1]) / timed
    tokens = args.batch * args.seq
    prof = _profiled_steps(step_fn, state, batch)
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms_per_step"] / step_ms
    n = stats["params"]
    # 6 N tokens products (x 4/3: remat runs the forward twice) against
    # AdamW's 28 bytes a parameter
    step_bound, bound_by = bound(28 * n, 6 * n * tokens
                                 * (4 / 3 if cfg.remat else 1))
    stats.update(step_ms=step_ms, timed_steps=timed,
                 tokens_per_s=tokens / step_ms * 1e3, profile=prof,
                 peak_bytes=torch.cuda.max_memory_allocated(dev),
                 bound_ms=step_bound, bound_by=bound_by)
    stats.update(_adamw_times(state, args.lr))
    stats.update(allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                 model_s=time.perf_counter() - t_model, card=smi)
    say("  train", json.dumps(stats))
    del res, state, batch
    torch.cuda.empty_cache()
    return stats


def phase_train(dev, smi):
    """LM training on the card: smollm-360m (8 steps, resume, loss drop),
    recurrentgemma-2b and xlstm-125m (3 steps) at full width through the
    launcher's own function; the ten smoke archs' step in f32 on the card
    against the port's own CPU step; the launcher's --arch udt --smoke.
    The RG-LRU and the sLSTM launch the linear scan forward and backward;
    --arch udt keeps the config's default backends, so its build launches
    no tree kernel, and its test-split predict is one walk launch."""
    import argparse
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    need(not torch.backends.cuda.matmul.allow_tf32,
         "train: torch.backends.cuda.matmul.allow_tf32 is on")
    ops.reset_launch_counts()
    t0 = _sync_clock(dev)
    with tempfile.TemporaryDirectory() as tmp:
        full = [_train_full_width(arch, steps, dev, smi, tmp)
                for arch, steps in TRAIN_FULL]
    t1 = _sync_clock(dev)
    card_vs_cpu = {arch: _train_card_vs_cpu(arch, dev)
                   for arch in configs.ARCH_IDS}
    t2 = _sync_clock(dev)
    udt = launch_train.train_udt(argparse.Namespace(
        dataset="churn_modeling", scale=1.0, bins=128, smoke=True,
        ckpt_dir=""), dev)
    t3 = _sync_clock(dev)
    launches = ops.launch_counts()
    say("  train", json.dumps(dict(
        card_vs_cpu=card_vs_cpu, tolerance=TRAIN_CARD_VS_CPU,
        udt=dict(nodes=udt["tree"].n_nodes,
                 depth=udt["tree"].max_tree_depth,
                 configs=udt["tune"].n_configs,
                 dmax=udt["tune"].best_dmax, smin=udt["tune"].best_smin,
                 test_acc=udt["test_acc"]),
        full_width_s=t1 - t0, card_vs_cpu_s=t2 - t1, udt_s=t3 - t2,
        peak_bytes=max(f["peak_bytes"] for f in full),
        launches=launches, card=smi)))
    bad = {a: e for a, e in card_vs_cpu.items()
           if not (e["loss_rel"] <= TRAIN_CARD_VS_CPU
                   and (e["normalizer_flips"] > 0 or (
                       e["grad_norm_rel"] <= TRAIN_CARD_VS_CPU
                       and e["params_max_abs"] <= TRAIN_CARD_VS_CPU
                       and e["params_max_abs_anywhere"] <= 2 * 3e-4
                       + TRAIN_CARD_VS_CPU)))}
    need(not bad, f"train: card against CPU beyond {TRAIN_CARD_VS_CPU}: {bad}")
    need(_tree_launches(launches) == {"walk": 1},
         f"train: the training path launched a tree kernel beyond the "
         f"udt predict's walk: {launches}")
    need(launches["linear_scan"] > 0 and launches["linear_scan_backward"] > 0,
         f"train: the RG-LRU / sLSTM steps did not launch the linear scan "
         f"both ways: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase mesh: the sharded LM on a 1-rank NCCL group, 1x1 mesh
# ---------------------------------------------------------------------------

MESH_ARCH = "smollm-360m"
MESH_TRAIN_STEPS = 3
# the model whose sLSTM runs its local block (and the linear scan) on the
# mesh
MESH_RECURRENT_ARCH = "xlstm-125m"


def _counts_by_tag(comm, per=1):
    """{op/tag: [calls, bytes]} of a Collectives' counts, divided by
    ``per`` (a step's share)."""
    return {f"{op}/{tag}": [c[0] / per, c[1] / per]
            for (op, tag), c in sorted(comm.counts.items())}


def _axes_off():
    """Remove the installed mesh; returns what puts it back."""
    from repro_torch.models import sharding as SH
    saved = (SH.ACT_AXES, SH.MESH, SH.COMM)
    SH.set_activation_axes(None, None)
    return lambda: SH.set_activation_axes(*saved)


def _decode_ms(model, prompt, gen, dev):
    """Prefill, then ``gen`` decode steps timed with CUDA events: (ms a
    step, the prefill's last logits, the tokens)."""
    import torch
    from repro_torch.serve import serve as S
    logits, cache = S.prefill(model, prompt, prompt.shape[1] + gen + 1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize(dev)
    ev[0].record()
    toks, _ = S.decode_loop(model, logits, cache, gen)
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / gen, logits, toks


def _step_ms(step_fn, state, batch, reps=2):
    import torch
    step_fn(state, batch)                       # warm-up
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        step_fn(state, batch)
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def _mesh_moe(dev):
    """arctic-smoke's MoE block in f32 on the 1x1 mesh, on the a2a path
    (B 4 x T 32: 128 tokens, at least 64 a rank) and the local path (B 2 x
    T 8), against the plain path where the capacities agree (both here:
    ceil(k n / E * 1.25) is above both floors)."""
    import dataclasses
    import math
    import torch
    from repro_torch import configs
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as SH
    cfg = dataclasses.replace(configs.get_smoke("arctic_480b"),
                              dtype="float32")
    g = torch.Generator(device=dev).manual_seed(4)
    p = MOE.init_moe(g, cfg, torch.float32, dev)
    out = {}
    for path, (b, t) in (("a2a", (4, 32)), ("local", (2, 8))):
        x = torch.randn((b, t, cfg.d_model), generator=g, device=dev)
        n = b * t
        caps = [min(max(floor, math.ceil(cfg.top_k * n / cfg.n_experts
                                          * cfg.moe_capacity_factor)), n)
                for floor in ((4 if path == "a2a" else 8), 8)]
        before = dict(SH.COMM.counts)
        got = MOE.moe_block(p, x, cfg)
        issued = {f"{op}/{tag}" for (op, tag), c in SH.COMM.counts.items()
                  if c[0] > before.get((op, tag), [0])[0]}
        back = _axes_off()
        try:
            want = MOE._moe_block_plain(p, x, cfg)
        finally:
            back()
        out[path] = dict(tokens=n, capacity=caps[0], plain_capacity=caps[1],
                         collectives=sorted(issued),
                         max_abs=float((got - want).abs().max()))
        need(caps[0] == caps[1], f"mesh: moe {path} capacities differ")
        need(("all_to_all_single/moe" if path == "a2a" else "all_reduce/moe")
             in issued, f"mesh: moe {path} path not taken: {issued}")
        need(out[path]["max_abs"] == 0.0, f"mesh: moe {path} against the "
             f"plain path {out[path]['max_abs']}")
    return out


def phase_mesh(dev, smi):
    """The sharded LM (models/sharding.py, placement.py, the mesh paths of
    layers / moe / rglru / xlstm, the sharded train step) on a 1-rank NCCL
    group with a 1x1 ("data", "model") mesh: every collective has size 1,
    so the sharded code must equal the plain path bit for bit.
    smollm-360m at full width through the launchers' own functions: 32
    greedy tokens at batch 4 and prompt 16 (equal to phase lm's, the
    prefill's logits equal to the no-mesh model's), and 3 train steps at
    batch 8 and seq 128 equal to a no-mesh run from the same seed; decode
    ms a step and step ms beside the no-mesh ones (CUDA events, same
    call), the collectives a step by tag, the device idle share;
    xlstm-125m's 3 train steps equal to a no-mesh run from the same seed
    (the sLSTM's local block and the linear scan), its collectives a step
    by tag; then arctic-smoke's MoE block on the a2a and local paths
    against the plain path.  The linear scan is the only csrc kernel on
    this path: the counts are set to 0 after the no-mesh runs and read
    after smollm-360m's mesh runs (which launch no csrc kernel), then set
    to 0 again just before xlstm-125m's mesh run and read just after it,
    so the phase's launches are that run's own."""
    import tempfile
    import torch
    import torch.distributed as tdist
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import sharding as SH
    from repro_torch.train import make_train_step
    need(not tdist.is_initialized(), "mesh: a process group is left over")
    t0 = _sync_clock(dev)
    serve_argv = ["--arch", MESH_ARCH]
    train_argv = ["--arch", MESH_ARCH, "--steps", str(MESH_TRAIN_STEPS)]
    # the no-mesh runs first: no process group, so the launchers take the
    # plain path
    plain_serve = launch_serve.serve_lm(
        launch_serve.build_parser().parse_args(serve_argv), dev)
    plain_train = launch_train.train_lm(
        launch_train.build_parser().parse_args(train_argv), dev)
    xl_argv = ["--arch", MESH_RECURRENT_ARCH, "--steps",
               str(MESH_TRAIN_STEPS)]
    plain_xl = launch_train.train_lm(
        launch_train.build_parser().parse_args(xl_argv), dev)
    need(SH.COMM is None, "mesh: the no-mesh launcher installed a mesh")
    ops.reset_launch_counts()
    stats = dict(mesh=MESH_ARCH, shape=[1, 1])
    on_card = dev.type == "cuda"            # gloo only in a CPU rehearsal
    with tempfile.TemporaryDirectory() as tmp:
        if on_card:
            torch.cuda.set_device(0 if dev.index is None else dev.index)
        tdist.init_process_group("nccl" if on_card else "gloo",
                                 init_method=f"file://{tmp}/store", rank=0,
                                 world_size=1)
        try:
            serve = launch_serve.serve_lm(
                launch_serve.build_parser().parse_args(serve_argv), dev)
            comm = SH.COMM
            need(comm is not None and SH.ACT_AXES.sizes == {"data": 1,
                                                            "model": 1},
                 "mesh: the launcher did not install the 1x1 mesh")
            toks = serve["tokens"]
            args = launch_serve.build_parser().parse_args(serve_argv)
            comm.counts.clear()
            mesh_ms, mesh_logits, _ = _decode_ms(serve["model"],
                                                 serve["prompt"], args.gen,
                                                 dev)
            decode_counts = _counts_by_tag(comm, args.prompt_len + args.gen)
            back = _axes_off()
            try:
                plain_ms, plain_logits, _ = _decode_ms(
                    plain_serve["model"], plain_serve["prompt"], args.gen,
                    dev)
            finally:
                back()
            logits_diff = float((mesh_logits - plain_logits).abs().max())
            decode_prof = _profiled_decode(serve["model"], serve["prompt"],
                                           dev)
            decode_prof["device_idle_share"] = (
                1.0 - decode_prof["device_busy_ms_per_step"] / mesh_ms)
            stats["serve"] = dict(
                batch=args.batch, prompt=args.prompt_len, gen=args.gen,
                tokens_equal_phase_lm=bool(torch.equal(
                    toks, LM_TOKENS.get(MESH_ARCH, plain_serve["tokens"]))),
                tokens_equal_no_mesh=bool(torch.equal(
                    toks, plain_serve["tokens"])),
                prefill_logits_max_abs=logits_diff,
                decode_ms_per_step=mesh_ms,
                no_mesh_decode_ms_per_step=plain_ms,
                collectives_per_step=decode_counts, profile=decode_prof)
            del serve, plain_serve
            need(stats["serve"]["tokens_equal_phase_lm"]
                 and stats["serve"]["tokens_equal_no_mesh"],
                 "mesh: the mesh's tokens differ from phase lm's")
            need(logits_diff == 0.0, f"mesh: prefill logits {logits_diff} "
                 "from the no-mesh model's")
            need(any(k.startswith("all_reduce/") for k in decode_counts),
                 f"mesh: decode issued no collective: {decode_counts}")

            comm.counts.clear()
            train = launch_train.train_lm(
                launch_train.build_parser().parse_args(train_argv), dev)
            train_counts = _counts_by_tag(SH.COMM, MESH_TRAIN_STEPS)
            comm = SH.COMM
            pm = dict(plain_train["state"].model.named_parameters())
            diff = max(float((p.detach() - pm[n].detach()).abs().max())
                       for n, p in
                       train["state"].model.named_parameters())
            for k in ("m", "v"):
                diff = max(diff, max(
                    float((t.float() - plain_train["state"].opt[k][n]
                           .float()).abs().max())
                    for n, t in train["state"].opt[k].items()))
            losses = [float(m["loss"]) for m in train["metrics"]]
            plain_losses = [float(m["loss"]) for m in plain_train["metrics"]]
            gnorms = [float(m["grad_norm"]) for m in train["metrics"]]
            plain_gnorms = [float(m["grad_norm"])
                            for m in plain_train["metrics"]]
            cfg = train["state"].model.cfg
            targs = launch_train.build_parser().parse_args(train_argv)
            batch = launch_train.synthetic_lm_batch(
                cfg, targs.batch, targs.seq, MESH_TRAIN_STEPS, device=dev)
            step_fn = make_train_step(cfg, lr=targs.lr)
            mesh_step_ms = _step_ms(step_fn, train["state"], batch)
            prof = _profiled_steps(step_fn, train["state"], batch, steps=1)
            prof["device_idle_share"] = (
                1.0 - prof["device_busy_ms_per_step"] / mesh_step_ms)
            back = _axes_off()
            try:
                plain_step_ms = _step_ms(step_fn, plain_train["state"],
                                         batch)
            finally:
                back()
            stats["train"] = dict(
                batch=targs.batch, seq=targs.seq, steps=MESH_TRAIN_STEPS,
                losses=losses, no_mesh_losses=plain_losses,
                grad_norms=gnorms, no_mesh_grad_norms=plain_gnorms,
                state_max_abs=diff, step_ms=mesh_step_ms,
                no_mesh_step_ms=plain_step_ms,
                collectives_per_step=train_counts, profile=prof)
            del train, plain_train
            torch.cuda.empty_cache()
            need(losses == plain_losses and gnorms == plain_gnorms
                 and diff == 0.0, f"mesh: {MESH_TRAIN_STEPS} steps on the "
                 f"mesh differ from the no-mesh run (state {diff}, losses "
                 f"{losses} / {plain_losses})")
            need("all_reduce/grad" in train_counts, "mesh: the train step "
                 f"issued no gradient reduce: {train_counts}")

            smollm_launches = ops.launch_counts()
            SH.COMM.counts.clear()
            ops.reset_launch_counts()
            xl = launch_train.train_lm(
                launch_train.build_parser().parse_args(xl_argv), dev)
            launches = ops.launch_counts()
            xl_counts = _counts_by_tag(SH.COMM, MESH_TRAIN_STEPS)
            xl_diff = _state_diff(xl["state"], plain_xl["state"])
            stats["xlstm"] = dict(
                arch=MESH_RECURRENT_ARCH, steps=MESH_TRAIN_STEPS,
                losses=[float(m["loss"]) for m in xl["metrics"]],
                no_mesh_losses=[float(m["loss"])
                                for m in plain_xl["metrics"]],
                grad_norms=[float(m["grad_norm"]) for m in xl["metrics"]],
                no_mesh_grad_norms=[float(m["grad_norm"])
                                    for m in plain_xl["metrics"]],
                state_max_abs=xl_diff, collectives_per_step=xl_counts)
            del xl, plain_xl
            torch.cuda.empty_cache()
            x = stats["xlstm"]
            need(x["losses"] == x["no_mesh_losses"]
                 and x["grad_norms"] == x["no_mesh_grad_norms"]
                 and xl_diff == 0.0, f"mesh: {MESH_RECURRENT_ARCH}'s "
                 f"{MESH_TRAIN_STEPS} steps on the mesh differ from the "
                 f"no-mesh run (state {xl_diff}, losses {x['losses']} / "
                 f"{x['no_mesh_losses']})")
            need("all_to_all_single/slstm" in xl_counts,
                 f"mesh: the sLSTM did not run its local block: {xl_counts}")
            stats["moe"] = _mesh_moe(dev)
        finally:
            SH.set_activation_axes(None, None)
            tdist.destroy_process_group()
    stats.update(mesh_s=_sync_clock(dev) - t0, launches=launches,
                 smollm_launches=smollm_launches, card=smi)
    say("  mesh", json.dumps(stats))
    need(not any(smollm_launches.values()),
         f"mesh: {MESH_ARCH}'s runs launched a csrc kernel: "
         f"{smollm_launches}")
    need(not _tree_launches(launches),
         f"mesh: the sharded LM launched a tree kernel: {launches}")
    need(launches["linear_scan"] > 0 and launches["linear_scan_backward"] > 0,
         f"mesh: the sLSTM's local block did not launch the linear scan "
         f"both ways: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase dryrun: the dry-run analysis against real steps on the card
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "smollm-360m"
DRYRUN_RECURRENT_ARCH = "xlstm-125m"    # its sLSTM runs the linear scan
DRYRUN_BATCH, DRYRUN_SEQ = 8, 128       # phase train's shape
DRYRUN_MEM_TOL = 0.25
UDT_ROWS, UDT_FEATS, UDT_CLASSES, UDT_SLOTS = 1 << 20, 48, 24, 256


def _dryrun_cells():
    """(i) The production cells the card's host can afford, recorded on
    fake CPU tensors: smollm-360m's four shapes on 16x16 (long_500k is a
    SKIP row) and the UDT cell on both meshes.  Host work: nothing runs on
    the card."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rows = [dryrun.run_cell(DRYRUN_ARCH, shape, "16x16", verbose=False)
            for shape in configs.SHAPES]
    rows += [dryrun.run_udt_cell(mesh, verbose=False)
             for mesh in ("16x16", "2x16x16")]
    keep = ("arch", "shape", "mesh", "status", "compute_s", "memory_s",
            "collective_s", "bottleneck", "step_lower_bound_s",
            "model_vs_hlo", "lower_compile_s")
    out = [{k: r[k] for k in keep if k in r} for r in rows]
    for r, o in zip(rows, out):
        if r["status"] == "OK":
            o["hbm_per_rank_bytes"] = (r["memory"]["argument_bytes"]
                                       + r["memory"]["temp_bytes"])
    say("  dryrun", json.dumps(dict(check="cells", rows=out,
                                    host_s=time.perf_counter() - t0)))
    bad = [f"{r['arch']} x {r['shape']} [{r['mesh']}]: {r['status']}"
           for r in rows
           if r["status"] != "OK" and not r["status"].startswith("SKIP")]
    need(not bad, f"dryrun: cells failed: {bad}")
    need(sum(r["status"].startswith("SKIP") for r in rows) == 1,
         "dryrun: smollm-360m x long_500k is not the one SKIP row")


def _dryrun_fake_vs_real(dev, smi):
    """(ii) smollm-360m at full width, phase train's shape, no mesh: the
    forward and the train step recorded on fake CPU tensors, then run for
    real on the card under the same counter.  FLOPs and bytes equal as
    integers; the real ms (CUDA events) at least the analysis's bound;
    argument + temp bytes within 25 % of the step's peak allocation."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs
    from repro_torch.launch import analysis, specs
    from repro_torch.models import model as M
    from repro_torch.train import init_train_state, make_train_step
    cfg = configs.get(DRYRUN_ARCH)
    tree = {k: torch.empty((DRYRUN_BATCH, DRYRUN_SEQ), dtype=torch.int32,
                           device="meta") for k in ("tokens", "labels")}
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fstate = specs.fake_state(cfg, mode)
    fbatch = specs.fake_inputs(tree, mode)
    with mode:
        with torch.no_grad():
            fake = {"forward": analysis.count(
                M.forward, fstate.model, {"tokens": fbatch["tokens"]})}
        fake["train_step"] = analysis.count(step, fstate, fbatch)
    fake_s = time.perf_counter() - t0
    del fstate, fbatch
    g = torch.Generator(device=dev).manual_seed(11)
    state = init_train_state(cfg, g, device=dev)
    batch = {k: torch.randint(0, cfg.vocab, v.shape, generator=g,
                              dtype=torch.int32, device=dev)
             for k, v in tree.items()}
    tokens = {"tokens": batch["tokens"]}
    with torch.no_grad():
        real = {"forward": analysis.count(M.forward, state.model, tokens)}
        fwd_ms = cuda_ms(lambda: M.forward(state.model, tokens), reps=5,
                         warmup=1)
    real["train_step"] = analysis.count(step, state, batch)
    step_ms = _step_ms(step, state, batch, reps=3)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = dict(check="fake_vs_real", arch=DRYRUN_ARCH, batch=DRYRUN_BATCH,
               seq=DRYRUN_SEQ, fake_host_s=fake_s)
    for what, ms in (("forward", fwd_ms), ("train_step", step_ms)):
        a = analysis.analyze(real[what], 1)
        out[what] = dict(
            flops=real[what]["flops"], fake_flops=fake[what]["flops"],
            bytes=real[what]["bytes_accessed"],
            fake_bytes=fake[what]["bytes_accessed"], ops=real[what]["ops"],
            ms=ms, bound_ms=a["step_lower_bound_s"] * 1e3,
            bottleneck=a["bottleneck"], compute_ms=a["compute_s"] * 1e3,
            memory_ms=a["memory_s"] * 1e3, memory=real[what]["memory"])
    mem = real["train_step"]["memory"]
    other = resident - mem["argument_bytes"]      # not the state or batch
    counted = mem["argument_bytes"] + mem["temp_bytes"]
    out["peak"] = dict(max_memory_allocated=peak, resident=resident,
                       resident_other=other, counted=counted,
                       gap=counted / (peak - other) - 1.0)
    out["card"] = smi
    say("  dryrun", json.dumps(out))
    del state, batch
    torch.cuda.empty_cache()
    for what in ("forward", "train_step"):
        o = out[what]
        need(o["flops"] == o["fake_flops"] and o["bytes"] == o["fake_bytes"],
             f"dryrun: {what} fake and real counts differ: {o}")
        need(o["ms"] >= o["bound_ms"],
             f"dryrun: {what} {o['ms']} ms beat its bound {o['bound_ms']}")
        need(o["flops"] > 0, f"dryrun: {what} counted no FLOPs")
    need(abs(out["peak"]["gap"]) <= DRYRUN_MEM_TOL,
         f"dryrun: argument + temp bytes {counted} against the step's peak "
         f"{peak - other}: {out['peak']['gap']:+.3f}")


def _dryrun_recurrent_fake_vs_real(dev, smi):
    """(ii) xlstm-125m's train step at phase train's shape, no mesh,
    recorded on fake CPU tensors and counted for real on the card: FLOPs,
    bytes and ops equal as integers (the linear scan is one op each way,
    counted as its operands' bytes on both devices); the real ms (CUDA
    events) at least the analysis's bound.  Returns the counted step's
    launches."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import analysis, specs
    from repro_torch.train import init_train_state, make_train_step
    cfg = configs.get(DRYRUN_RECURRENT_ARCH)
    tree = {k: torch.empty((DRYRUN_BATCH, DRYRUN_SEQ), dtype=torch.int32,
                           device="meta") for k in ("tokens", "labels")}
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fstate = specs.fake_state(cfg, mode)
    fbatch = specs.fake_inputs(tree, mode)
    with mode:
        fake = analysis.count(step, fstate, fbatch)
    fake_s = time.perf_counter() - t0
    del fstate, fbatch
    g = torch.Generator(device=dev).manual_seed(11)
    state = init_train_state(cfg, g, device=dev)
    batch = {k: torch.randint(0, cfg.vocab, v.shape, generator=g,
                              dtype=torch.int32, device=dev)
             for k, v in tree.items()}
    ops.reset_launch_counts()
    real = analysis.count(step, state, batch)
    _sync_clock(dev)
    launches = ops.launch_counts()
    ms = _step_ms(step, state, batch, reps=3)
    a = analysis.analyze(real, 1)
    out = dict(check="fake_vs_real", arch=DRYRUN_RECURRENT_ARCH,
               batch=DRYRUN_BATCH, seq=DRYRUN_SEQ, fake_host_s=fake_s,
               train_step=dict(
                   flops=real["flops"], fake_flops=fake["flops"],
                   bytes=real["bytes_accessed"],
                   fake_bytes=fake["bytes_accessed"], ops=real["ops"],
                   fake_ops=fake["ops"], ms=ms,
                   bound_ms=a["step_lower_bound_s"] * 1e3,
                   bottleneck=a["bottleneck"],
                   compute_ms=a["compute_s"] * 1e3,
                   memory_ms=a["memory_s"] * 1e3),
               launches=launches, card=smi)
    say("  dryrun", json.dumps(out))
    del state, batch
    torch.cuda.empty_cache()
    o = out["train_step"]
    need(o["flops"] == o["fake_flops"] and o["bytes"] == o["fake_bytes"]
         and o["ops"] == o["fake_ops"],
         f"dryrun: {DRYRUN_RECURRENT_ARCH}'s fake and real counts differ: {o}")
    need(o["ms"] >= o["bound_ms"], f"dryrun: {DRYRUN_RECURRENT_ARCH}'s "
         f"step {o['ms']} ms beat its bound {o['bound_ms']}")
    need(launches["linear_scan"] > 0 and launches["linear_scan_backward"] > 0,
         f"dryrun: the counted step did not launch the linear scan: "
         f"{launches}")
    return launches


def _udt_kernel_bytes(m, k, c, s, b):
    """Bytes the chunk's two kernel launches need (the dispatch mode does
    not see a ctypes launch): the histogram reads every row's slot, bins
    and stats (every row lies in the chunk) and writes [S, K, B, C]; the
    split scan reads that and writes its [S, K] decisions."""
    hist = s * k * b * c * 4
    return m * 4 + m * (k + c) * 4 + hist + hist + 2 * k * 4 + s * k * 12


def _dryrun_udt_real(dev, smi):
    """(iii) The UDT cell run for real at full size (m = 2^20 rows of
    random bins, k = 48, C = 24, 256 slots, 2^20 nodes) on a 1-rank NCCL
    group (gloo in a CPU rehearsal), with the kernel backends: both
    kernels launch; the NCCL Collectives' log equals, call for call, a
    1x1 RecordingCollectives recording of the same step; the chunk's ms is
    at least its bound.  Returns the counted run's launches."""
    import tempfile
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.collectives import Collectives, RecordingCollectives
    from repro_torch.core.distributed import DistConfig, make_sharded_step
    from repro_torch.kernels import ops
    from repro_torch.launch import analysis, dryrun
    need(not tdist.is_initialized(), "dryrun: a process group is left over")
    kw = dryrun.udt_kw(backend="kernel")
    dist = DistConfig()

    def inputs():
        g = torch.Generator(device=dev).manual_seed(5)
        return dryrun.udt_inputs(UDT_ROWS, UDT_FEATS, 256, UDT_CLASSES,
                                 UDT_SLOTS, device=dev, generator=g)

    on_card = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        if on_card:
            torch.cuda.set_device(0 if dev.index is None else dev.index)
        tdist.init_process_group("nccl" if on_card else "gloo",
                                 init_method=f"file://{tmp}/store", rank=0,
                                 world_size=1)
        try:
            mesh = init_device_mesh(dev.type, (1, 1),
                                    mesh_dim_names=("data", "model"))
            comm = Collectives(mesh)
            step = make_sharded_step(comm, dist, kw, UDT_SLOTS)
            args = inputs()
            ops.reset_launch_counts()
            counts = analysis.count(step, *args, comm=comm)
            _sync_clock(dev)
            launches = ops.launch_counts()
            ms = cuda_ms(lambda: step(*args), reps=5, warmup=1)
        finally:
            tdist.destroy_process_group()
    del args
    rec = RecordingCollectives((("data", 1), ("model", 1)))
    recorded = analysis.count(make_sharded_step(rec, dist, kw, UDT_SLOTS),
                              *inputs(), comm=rec)
    calls = [(c.op, c.tag, c.nbytes) for c in counts["log"]]
    want = [(c.op, c.tag, c.nbytes) for c in recorded["log"]]
    kernel_bytes = _udt_kernel_bytes(UDT_ROWS, UDT_FEATS, UDT_CLASSES,
                                     UDT_SLOTS, 256)
    a = analysis.analyze(dict(counts, bytes_accessed=counts["bytes_accessed"]
                              + kernel_bytes), 1)
    out = dict(check="udt_real", rows=UDT_ROWS, feats=UDT_FEATS,
               classes=UDT_CLASSES, slots=UDT_SLOTS, ms=ms,
               bound_ms=a["step_lower_bound_s"] * 1e3,
               bottleneck=a["bottleneck"],
               aten_bytes=counts["bytes_accessed"], kernel_bytes=kernel_bytes,
               collective_calls=dryrun.collective_calls(counts["log"]),
               log_equal_recording=calls == want, launches=launches,
               card=smi)
    say("  dryrun", json.dumps(out))
    torch.cuda.empty_cache()
    need(calls == want, f"dryrun: the NCCL log {calls} differs from the "
         f"recording's {want}")
    need(any(v for k_, v in launches.items() if k_.startswith("histogram"))
         and launches["split_scan"] > 0,
         f"dryrun: the UDT cell did not launch both kernels: {launches}")
    need(ms >= out["bound_ms"],
         f"dryrun: the UDT chunk's {ms} ms beat its bound {out['bound_ms']}")
    return launches


def phase_dryrun(dev, smi):
    """The dry-run analysis (launch/analysis, specs, dryrun) held against
    the card: (i) the production cells the host can afford, (ii)
    smollm-360m's forward and train step and xlstm-125m's train step fake
    against real, (iii) the UDT cell for real through both kernels.  One
    ``dryrun`` JSON line a check; any failed check fails the phase."""
    t0 = time.perf_counter()
    _dryrun_cells()
    _dryrun_fake_vs_real(dev, smi)
    recurrent = _dryrun_recurrent_fake_vs_real(dev, smi)
    udt = _dryrun_udt_real(dev, smi)
    say(f"  dryrun phase {time.perf_counter() - t0:.1f} s")
    return {k: recurrent[k] + udt[k] for k in udt}


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _build
        from repro_torch.core.tree import _auto_chunk_slots
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    say("phase 1: device")
    name, count, smi = torch.cuda.get_device_name(0), torch.cuda.device_count(), smi_line()
    say(f"  {name}; devices {count}; nvidia-smi: {smi}")
    say(f"  torch {torch.__version__} cuda {torch.version.cuda}; python "
        f"{sys.version.split()[0]}")

    say("phase 2: build")
    t0 = time.perf_counter()
    _build.library()
    say(f"  nvcc build + load {time.perf_counter() - t0:.1f} s")
    for line in _build.ptxas_report().splitlines():
        if any(w in line for w in ("==", "Compiling entry", "registers",
                                   "spill", "smem")):
            say("  " + line.strip())

    say("phase 3: kernels against their plain versions")
    widest = _auto_chunk_slots(N_FEAT, 257, N_CLASS, 1 << 28)
    widest -= widest % 2                       # the builder's even chunk
    kdd = kdd99_table()
    parity = phase_parity(dev, widest, kdd[:2])
    wide_class = phase_wide_class(dev)
    widest_rv = _auto_chunk_slots(N_FEAT, 257, 3, 1 << 28)
    widest_rv -= widest_rv % 2                 # a softmax round's widest
    stacked = phase_stacked(dev, widest_rv)
    scan = phase_linear_scan(dev)
    walk = phase_walk(dev)
    say(f"  all kernel modes agree (t={time.perf_counter() - t_start:.0f} s)")

    say("phase 4: paper config on the KDD99-10% twin")
    launch_kdd, _, kdd_tree = phase_kdd99(dev, *kdd)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase 5: wide hybrid table, multi-chunk levels")
    launch_wide, wide_stats = phase_wide(dev, M_ROWS)
    need(wide_stats["widest_level"] > 16, "wide phase levels stayed narrow")
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase toot: Training-Only-Once Tuning on the KDD99-10% twin")
    launch_toot = phase_toot(dev, *kdd[:2], smi)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase gbt: Newton / GOSS boosting on the KDD99-10% twin")
    launch_gbt, gbt_fit_s, gbt_ens = phase_gbt(dev, *kdd[:2], smi)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase softmax: multiclass Newton / GOSS boosting on the twin")
    launch_softmax, softmax_fit_s = phase_softmax(dev, *kdd[:2], smi,
                                                  gbt_fit_s)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase forest: RandomForest on the twin")
    launch_forest, forest_rf, forest_fit_s = phase_forest(dev, *kdd[:2], smi)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase resume: round and level checkpoints, bit-identical resume")
    launch_resume = phase_resume(dev, *kdd[:2], smi)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase serve: two tenants on the card, bucketed CUDA-graph server")
    launch_serve = phase_serve(dev, *kdd[:2], smi, gbt_ens)
    del gbt_ens
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase chaos: the seeded 14-fault scenario on the card")
    launch_chaos = phase_chaos(dev, smi)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase dist: the sharded build on a 1-rank NCCL group")
    launch_dist = phase_dist(dev, *kdd[:2], smi, kdd_tree, forest_rf,
                             dict(gbt=gbt_fit_s, softmax=softmax_fit_s,
                                  forest=forest_fit_s))
    del forest_rf
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase check: the contract gate (repro_torch.check) on the card")
    launch_check = phase_check(dev, widest, widest_rv, smi)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase lm: the LM serving path at full width, and the smoke archs")
    launch_lm = phase_lm(dev, smi)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase train: LM training at full width, and the smoke archs")
    launch_train = phase_train(dev, smi)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase mesh: the sharded LM on a 1-rank NCCL group, 1x1 mesh")
    launch_mesh = phase_mesh(dev, smi)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase dryrun: the dry-run analysis against real steps on the card")
    launch_dryrun = phase_dryrun(dev, smi)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase 6: kernels")
    phases = {"kdd99": launch_kdd, "wide": launch_wide, "toot": launch_toot,
              "gbt": launch_gbt, "softmax": launch_softmax,
              "forest": launch_forest, "resume": launch_resume,
              "serve": launch_serve, "chaos": launch_chaos,
              "dist": launch_dist, "check": launch_check, "lm": launch_lm,
              "train": launch_train, "mesh": launch_mesh,
              "dryrun": launch_dryrun}
    src_h = "src/repro_torch/csrc/histogram.cu"
    src_s = "src/repro_torch/csrc/split_scan.cu"
    rep_h = "src/repro/kernels/histogram.py:226"
    rep_s = "src/repro/kernels/split_scan.py:79"
    kernels = []
    for mode in ("plain", "weights", "slot_map", "fused", "pairs"):
        key = "histogram" if mode == "plain" else f"histogram_{mode}"
        r = parity[("histogram", mode, 16, True)]
        kernels.append(dict(
            name=key, route="cuda", source=src_h, replaces=rep_h,
            launches=sum(v[key] for v in phases.values()),
            launches_by_phase={ph: v[key] for ph, v in phases.items()},
            max_abs_err=max(v["max_abs_err"] for k, v in parity.items()
                            if k[0] == "histogram" and k[1] == mode),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=f"M={M_ROWS} K={N_FEAT} B=257 C={N_CLASS} S=16",
            parity="pass"))
        if mode in ("weights", "fused", "pairs"):
            kernels[-1]["float_path"] = {
                kind: {f: parity[("histogram_float", mode, kind, 16)][f]
                       for f in ("ms", "plain_ms", "bound_ms", "library_ms",
                                 "max_abs_err", "differing_cells")}
                for kind in ("float_w", "moments")}
        if ("histogram", mode) in wide_class:
            kernels[-1]["wide_class"] = wide_class[("histogram", mode)]
    r = stacked[("weights", 16)]
    kernels.append(dict(
        name="histogram_stacked", route="cuda", source=src_h, replaces=rep_h,
        launches=sum(v["histogram_stacked"] for v in phases.values()),
        launches_by_phase={ph: v["histogram_stacked"]
                           for ph, v in phases.items()},
        max_abs_err=max(v["max_abs_err"] for v in stacked.values()),
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        shape=f"L={N_CLASS} M={SOFTMAX_ROWS} K={N_FEAT} B=257 C=3 S=16, "
              "weights (moments, float hessian weights)",
        **{m_: {f"S={s_}": {f: stacked[(m_, s_)][f]
                            for f in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "max_abs_err")}
                for _, s_ in sorted(stacked) if _ == m_}
           for m_ in ("slot_map", "fused", "pairs")},
        widest={f: stacked[("weights", widest_rv)][f]
                for f in ("S", "ms", "plain_ms", "bound_ms", "library_ms")},
        parity="pass"))
    r = parity[("split_scan", "info_gain", 16)]
    kernels.append(dict(
        name="split_scan", route="cuda", source=src_s, replaces=rep_s,
        launches=sum(v["split_scan"] for v in phases.values()),
        launches_by_phase={ph: v["split_scan"] for ph, v in phases.items()},
        max_abs_err=max(v["max_abs_err"] for k, v in parity.items()
                        if k[0] == "split_scan"),
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None,
        shape=f"S=16 K={N_FEAT} B=257 C={N_CLASS} info_gain", parity="pass",
        wide_class={heur: line for (kind, heur), line in wide_class.items()
                    if kind == "split_scan"}))
    src_l = "src/repro_torch/csrc/linear_scan.cu"
    rep_l = "src/repro/models/rglru.py:30"
    for key in ("linear_scan", "linear_scan_backward"):
        by_shape = {"x".join(map(str, shp)): scan[(key, shp)]
                    for shp in SCAN_SHAPES}
        r = scan[(key, SCAN_SHAPES[0])]
        kernels.append(dict(
            name=key, route="cuda", source=src_l, replaces=rep_l,
            replaces_note="jax.lax.associative_scan (not Pallas), also "
                          "src/repro/models/xlstm.py:162-163",
            launches=sum(v[key] for v in phases.values()),
            launches_by_phase={ph: v[key] for ph, v in phases.items()},
            max_abs_err=max(v["max_abs_err"] for v in by_shape.values()),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            library="none: no single PyTorch call",
            shape="B=8 T=128 D=1536 (xlstm-125m's sLSTM at batch 8, seq "
                  "128)",
            device_ms=r["device_ms"],
            shapes={k: {f: v[f] for f in ("ms", "device_ms", "plain_ms",
                                          "bound_ms", "share_of_bound",
                                          "max_abs_err")}
                    for k, v in by_shape.items()},
            parity="bit for bit"))
    r = walk["higgs"]
    kernels.append(dict(
        name="walk", route="cuda", source="src/repro_torch/csrc/walk.cu",
        replaces=None,
        replaces_note="none: the reference's walk is plain XLA "
                      "(src/repro/core/predict.py, _walk)",
        launches=sum(v["walk"] for v in phases.values()),
        launches_by_phase={ph: v["walk"] for ph, v in phases.items()},
        max_abs_err=0.0, ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        library="none: no single PyTorch call",
        shape="T=1 M=10500000 K=28, 511 nodes in 4194304 slots, 9 steps",
        device_ms=r["device_ms"],
        shapes={k_: {f: v[f] for f in ("ms", "device_ms", "plain_ms",
                                       "bound_ms", "share_of_bound")}
                for k_, v in walk.items()},
        parity="bit for bit"))
    for k in kernels:
        need(k["launches"] > 0, f"{k['name']} never launched on the main path")
    say(json.dumps({"kernels": kernels}))
    say(f"total {time.perf_counter() - t_start:.0f} s")
    say(smi_line())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
