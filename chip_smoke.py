#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version at the main path's shapes, and drives the
main path (bin once, grow a UDT level by level through the histogram and
split-scan kernels, predict) at KDD99-10% scale.

    python3 chip_smoke.py            # needs one CUDA card; ~10 minutes

Phases (any failure exits non-zero):
  1. device      card name, count, nvidia-smi name / power limit
  2. build       nvcc build of csrc/*.cu, -Xptxas -v lines
  3. parity      every kernel mode against its plain version at the main
                 path's shapes (M=494,021, K=41, B=257, C=5; S=16 and the
                 widest chunk), CUDA-event times of kernel / plain / library
  4. kdd99       the paper config on the synthetic KDD99-10% twin: kernel
                 build on the card, predict, and the same build on the CPU
                 (plain versions) must give the same tree
  5. wide        494,021 x 41 hybrid table with multi-chunk levels: the
                 subtraction-on tree equals the subtraction-off tree, and a
                 unit-weight build (weights mode) equals it too
  6. kernels     one JSON line: every kernel, its launches on the main
                 paths (phases 4 and 5), parity and times
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
# H100 SXM data-sheet peaks (the bound_ms columns use them)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
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


def bound(nbytes, nops):
    """(least ms on the card, what bounds it) from data-sheet peaks."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# phase 3: every kernel mode against its plain version
# ---------------------------------------------------------------------------

def _hist_inputs(s, mode, integer_weights, dev, seed):
    """Main-path-shaped histogram inputs, made on the card from a seed;
    ``s`` raw slots (the builder's chunk width); slot_map / fused pack them
    into s // 2 pairs."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    bins = ints(0, 257, (M_ROWS, N_FEAT))
    stats = torch.eye(N_CLASS, device=dev)[ints(0, N_CLASS, (M_ROWS,)).long()]
    slot = ints(-1, s, (M_ROWS,))
    kw = dict(num_slots=s, n_bins=257)
    if mode == "weights":
        kw["weights"] = (ints(1, 4, (M_ROWS,)).float() if integer_weights
                         else torch.rand((M_ROWS,), generator=g, device=dev)
                         + 0.5)
    if mode in ("slot_map", "fused"):
        p = s // 2
        side = ints(0, 2, (p,)).long()
        compute = torch.zeros(s, dtype=torch.bool, device=dev)
        compute[2 * torch.arange(p, device=dev) + side] = True
        kw["slot_map"] = torch.where(
            compute, torch.arange(s, device=dev) // 2, -1).to(torch.int32)
        kw["num_slots"] = p
    if mode == "fused":
        kw["phist"] = ints(0, 9, (p, N_FEAT, 257, N_CLASS)).float()
        kw["side"] = (1 - side).to(torch.int32)
    return bins, stats, slot, kw


def _hist_cost(bins, stats, slot, kw):
    """Bytes and operations this call's data needs: every slot read, the
    bins / stats (/ weight) of the rows that land in the output, the
    optional tables, every output written once."""
    from repro_torch.kernels.histogram import remap_slots
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


# flops per scored candidate (logf counted as one), by heuristic, for C
# channels: the formulas of core/heuristics.py plus the pos/neg/count sums
_SCAN_OPS = {"info_gain": lambda c: 12 * c + 6, "gini": lambda c: 8 * c + 5,
             "chi_square": lambda c: 16 * c + 3, "sse": lambda c: 4 * c + 7}


def _scan_cost(hist, heuristic):
    s, k, b, c = hist.shape
    nbytes = hist.numel() * 4 + 2 * k * 4 + s * k * 12
    nops = s * k * b * (3 * c + 3 * _SCAN_OPS[heuristic](c))
    return nbytes, nops


def phase_parity(dev, widest):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.histogram import histogram_cuda, histogram_plain
    from repro_torch.kernels.split_scan import split_scan_cuda, split_scan_plain

    rows = {}
    for s in (16, widest):
        for mode in ("plain", "weights", "slot_map", "fused"):
            for integer_weights in ((True, False) if mode == "weights"
                                    else (True,)):
                bins, stats, slot, kw = _hist_inputs(s, mode, integer_weights,
                                                     dev, seed=s)
                got = histogram_cuda(bins, stats, slot, **kw)
                want = histogram_plain(bins, stats, slot, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
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
                    line["library_ms"] = None
                    if mode == "plain":
                        # one index_add_ over the prepared flat index / rows
                        keep = ((slot >= 0) & (slot < s)).nonzero()[:, 0]
                        idx = ((slot[keep].long()[:, None] * N_FEAT
                                + torch.arange(N_FEAT, device=dev)) * 257
                               + bins[keep].long()).reshape(-1)
                        src = stats[keep][:, None, :].expand(
                            -1, N_FEAT, -1).reshape(-1, N_CLASS).contiguous()
                        h = torch.zeros((s * N_FEAT * 257, N_CLASS), device=dev)
                        line["library_ms"] = cuda_ms(
                            lambda: h.index_add_(0, idx, src))
                        del idx, src, h
                say("  histogram", json.dumps(line))
                rows[("histogram", mode, s, integer_weights)] = line
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
            args = dict(heuristic=heur, min_leaf=1)
            s1, b1, o1 = split_scan_cuda(hist, n_num, n_cat, **args)
            s0, b0, o0 = split_scan_plain(hist, n_num, n_cat, **args)
            torch.cuda.synchronize()
            err = float((s1 - s0).abs().max())
            need(torch.allclose(s1, s0, rtol=1e-5, atol=1e-5),
                 f"split_scan {heur} S={s}: score mismatch (max abs {err})")
            unique = ref.best_is_unique(hist, n_num, n_cat, **args)
            need(torch.equal(b1[unique], b0[unique])
                 and torch.equal(o1[unique], o0[unique]),
                 f"split_scan {heur} S={s}: bin/op differ on a unique best")
            line = dict(S=s, heuristic=heur, max_abs_err=err,
                        non_unique=int((~unique).sum()),
                        ms=cuda_ms(lambda: split_scan_cuda(hist, n_num, n_cat,
                                                           **args)),
                        plain_ms=cuda_ms(lambda: split_scan_plain(
                            hist, n_num, n_cat, **args), reps=3, warmup=1),
                        library_ms=None)
            line["bound_ms"], line["bound_by"] = bound(*_scan_cost(hist, heur))
            say("  split_scan", json.dumps(line))
            rows[("split_scan", heur, s)] = line
        del h_cls, h_mom
        torch.cuda.empty_cache()
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


def phase_kdd99(dev):
    import torch
    from repro_torch.core import TreeConfig, fit_bins, predict_bins
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
    train, y_tr, te_bins, y_te = _split_rows(table, y, seed=0)
    cfg = TreeConfig(max_depth=64, min_samples_split=2, heuristic="info_gain",
                     hist_backend="kernel", select_backend="kernel")
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
    for name in ("histogram", "histogram_slot_map", "histogram_fused",
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
    return launches, stats


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
    parity = phase_parity(dev, widest)
    say(f"  all kernel modes agree (t={time.perf_counter() - t_start:.0f} s)")

    say("phase 4: paper config on the KDD99-10% twin")
    launch_kdd, _ = phase_kdd99(dev)
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase 5: wide hybrid table, multi-chunk levels")
    launch_wide, wide_stats = phase_wide(dev, M_ROWS)
    need(wide_stats["widest_level"] > 16, "wide phase levels stayed narrow")
    say(f"  (t={time.perf_counter() - t_start:.0f} s)")

    say("phase 6: kernels")
    src_h = "src/repro_torch/csrc/histogram.cu"
    src_s = "src/repro_torch/csrc/split_scan.cu"
    rep_h = "src/repro/kernels/histogram.py:226"
    rep_s = "src/repro/kernels/split_scan.py:79"
    kernels = []
    for mode in ("plain", "weights", "slot_map", "fused"):
        key = "histogram" if mode == "plain" else f"histogram_{mode}"
        r = parity[("histogram", mode, 16, True)]
        kernels.append(dict(
            name=key, route="cuda", source=src_h, replaces=rep_h,
            launches=launch_kdd[key] + launch_wide[key],
            launches_by_phase={"kdd99": launch_kdd[key],
                               "wide": launch_wide[key]},
            max_abs_err=max(v["max_abs_err"] for k, v in parity.items()
                            if k[0] == "histogram" and k[1] == mode),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=f"M={M_ROWS} K={N_FEAT} B=257 C={N_CLASS} S=16",
            parity="pass"))
    r = parity[("split_scan", "info_gain", 16)]
    kernels.append(dict(
        name="split_scan", route="cuda", source=src_s, replaces=rep_s,
        launches=launch_kdd["split_scan"] + launch_wide["split_scan"],
        launches_by_phase={"kdd99": launch_kdd["split_scan"],
                           "wide": launch_wide["split_scan"]},
        max_abs_err=max(v["max_abs_err"] for k, v in parity.items()
                        if k[0] == "split_scan"),
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None,
        shape=f"S=16 K={N_FEAT} B=257 C={N_CLASS} info_gain", parity="pass"))
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
