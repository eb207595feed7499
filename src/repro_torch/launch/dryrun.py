"""Dry run of every (architecture x input shape) cell on the production
meshes (counterpart of ``repro.launch.dryrun``): one recorded step per cell
and its roofline terms (``launch/analysis.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out experiments/dryrun_torch.json

The reference lowers and compiles each cell's step on 512 placeholder
devices.  The port has no such step: it records rank 0's step on its
blocks instead, as fake tensors (``FakeTensorMode``: nothing is allocated,
so a 480 B-parameter model records on a laptop) under a
``RecordingCollectives`` of the mesh's shape ("16x16": ``(data 16, model
16)``; "2x16x16": ``(pod 2, data 16, model 16)``), installed with
``set_activation_axes``.  Train cells record ``make_train_step`` on the
sharded state, prefill cells ``M.forward`` under ``torch.no_grad``, decode
cells ``serve.make_serve_step`` on the rank's cache block.  Skipped cells
(encoder decode, quadratic 500k) are SKIP rows, never dropped.  Rows keep
the reference's fields; ``lower_compile_s`` is the seconds the recording
took, and ``collective_calls`` gives the recorded collectives by
operation and tag (``[calls, bytes]``).

The reference corrects its counts for the depth of its scans.  The port
unrolls its layers, so depth needs none, and no op count depends on the
length through a loop over positions: the sLSTM and the RG-LRU run their
recurrence as one op each way (``repro_torch::linear_scan``), whose bytes
``analysis.count`` counts as those of its operands.  Every cell is
recorded whole, at its own length (the mLSTM's loop over chunks of 128
positions runs 256 times at 32k positions).

``run_udt_cell`` records the paper's own cell: one distributed level chunk
(``core.distributed.make_sharded_step``) of m = 2^20 rows, k = 48 features,
B = 256 bins, C = 24 label channels, 256 slots and 2^20 nodes, rank 0's
block of rows and features, with the reference's backends (``segment``
histograms, ``torch`` selection: the port's ``jnp``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.core.collectives import RecordingCollectives
from repro_torch.launch import analysis, specs
from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.serve import make_serve_step
from repro_torch.train import make_train_step

__all__ = ["MESHES", "production_comm", "record_cell", "run_cell",
           "run_udt_cell", "udt_kw", "udt_inputs", "collective_calls",
           "main"]

MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}


def production_comm(mesh_name: str):
    """(rank 0's ``RecordingCollectives``, its ``MeshAxes``) of a named
    production mesh."""
    shape = MESHES[mesh_name]
    comm = RecordingCollectives(shape)
    sizes = dict(shape)
    axes = SH.MeshAxes(data=tuple(a for a in sizes if a != "model"),
                       model="model", sizes=sizes)
    return comm, axes


def record_cell(cfg, shape_id: str, comm, axes, *, seq=None) -> dict:
    """``analysis.count`` of one cell's step on fake CPU tensors: rank 0's
    blocks under ``comm`` / ``axes`` (installed for the call); ``seq`` in
    place of the shape's length.  CPU tensors record on any build of
    PyTorch (``specs``)."""
    kind = configs.SHAPES[shape_id][2]
    ins = specs.input_specs(cfg, shape_id, seq)      # before any mesh
    if kind == "decode":
        spec = specs.decode_shardings(cfg, ins, axes)
    else:
        spec = specs.batch_shardings(ins, axes)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    batch = specs.fake_inputs(ins, mode, "cpu", comm, spec)
    state = specs.fake_state(cfg, mode, "cpu", comm, axes)
    saved = (SH.ACT_AXES, SH.MESH, SH.COMM)
    SH.set_activation_axes(axes, comm=comm)
    try:
        with mode:
            if kind == "train":
                return analysis.count(make_train_step(cfg), state, batch,
                                      comm=comm)
            if kind == "prefill":
                with torch.no_grad():
                    return analysis.count(M.forward, state.model, batch,
                                          comm=comm)
            return analysis.count(
                lambda model, tokens, cache: make_serve_step(model)(tokens,
                                                                    cache),
                state.model, batch["tokens"], batch["cache"], comm=comm)
    finally:
        SH.set_activation_axes(*saved)


def collective_calls(log) -> dict:
    """{"op/tag": [calls, bytes handed in]} of a ``Collectives.log``."""
    out: dict = {}
    for c in log:
        n = out.setdefault(f"{c.op}/{c.tag}", [0, 0])
        n[0] += 1
        n[1] += c.nbytes
    return dict(sorted(out.items()))


def run_cell(arch, shape_id, mesh_name, *, verbose=True):
    cfg = configs.get(arch)
    skip = configs.shape_skip_reason(cfg, shape_id)
    comm, axes = production_comm(mesh_name)
    chips = math.prod(axes.sizes.values())
    row = {"arch": arch, "shape": shape_id, "mesh": mesh_name,
           "chips": chips}
    if skip:
        row["status"] = f"SKIP({skip})"
        return row
    t0 = time.time()
    try:
        seq, bsz, kind = configs.SHAPES[shape_id]
        counts = record_cell(cfg, shape_id, comm, axes)
        res = analysis.analyze(counts, chips)
        row["lower_compile_s"] = round(time.time() - t0, 1)
        row["collective_calls"] = collective_calls(counts["log"])
        tokens = bsz * (1 if kind == "decode" else seq)
        mf = analysis.model_flops(cfg, kind, tokens)
        res["model_flops_global"] = mf
        res["hlo_flops_global"] = res["flops"] * chips
        res["model_vs_hlo"] = (mf / res["hlo_flops_global"]
                               if res["hlo_flops_global"] else None)
        row.update(res)
        row["status"] = "OK"
    except Exception as e:
        row["status"] = f"FAIL({type(e).__name__}: {e})"
        row["traceback"] = traceback.format_exc()[-2000:]
    if verbose:
        msg = row["status"]
        if row["status"] == "OK":
            msg += (f" t={row['lower_compile_s']}s"
                    f" bottleneck={row['bottleneck']}"
                    f" step>={row['step_lower_bound_s']:.3f}s"
                    f" model/hlo={row['model_vs_hlo'] and round(row['model_vs_hlo'], 3)}")
        print(f"[{mesh_name}] {arch} x {shape_id}: {msg}", flush=True)
    return row


def udt_kw(n_bins=256, max_nodes=1 << 20, backend="reference") -> dict:
    """The UDT cell's level-step settings: the reference's backends
    (``segment`` / ``torch``), or ``backend="kernel"`` for both kernels."""
    kernel = backend == "kernel"
    return dict(n_bins=n_bins, heuristic="info_gain", task="classification",
                min_samples_split=2, min_samples_leaf=1, max_depth=64,
                max_nodes=max_nodes,
                hist_backend="kernel" if kernel else "segment",
                select_backend="kernel" if kernel else "torch",
                n_label_bins=1)


def udt_inputs(m, k, n_bins=256, n_classes=24, num_slots=256,
               max_nodes=1 << 20, device="cpu", generator=None) -> tuple:
    """A level chunk's arguments on a block of ``m`` rows and ``k``
    features (``make_sharded_step``'s call): empty tensors, or with a
    ``generator`` (on ``device``) random bins, one-hot class rows and
    rows spread over the ``num_slots`` slots."""
    from repro_torch.core.tree import _init_arrays
    i32 = dict(dtype=torch.int32, device=device)
    if generator is None:
        bins = torch.empty((m, k), **i32)
        stats = torch.empty((m, n_classes), dtype=torch.float32,
                            device=device)
        assign = torch.empty((m,), **i32)
    else:
        draw = lambda hi, shape: torch.randint(  # noqa: E731
            0, hi, shape, generator=generator, **i32)
        bins = draw(n_bins, (m, k))
        stats = torch.nn.functional.one_hot(
            draw(n_classes, (m,)).long(), n_classes).float()
        assign = draw(num_slots, (m,))
    return (bins, stats, torch.zeros((m,), **i32),
            torch.zeros((m,), dtype=torch.float32, device=device), assign,
            _init_arrays(max_nodes + 1, device),              # + drop slot
            torch.zeros((1, 1, 1, 1), dtype=torch.float32, device=device),
            torch.full((k,), n_bins, **i32), torch.zeros((k,), **i32),
            0, num_slots, num_slots, 8)


def run_udt_cell(mesh_name, *, m_examples=1 << 20, k_feats=48, n_bins=256,
                 n_classes=24, num_slots=256, max_nodes=1 << 20,
                 verbose=True):
    """The paper-technique cell: one distributed UDT level chunk, rank 0's
    step on fake tensors."""
    from repro_torch.core.distributed import DistConfig, make_sharded_step
    comm, axes = production_comm(mesh_name)
    chips = math.prod(axes.sizes.values())
    row = {"arch": "udt_paper", "shape": f"m{m_examples}_k{k_feats}",
           "mesh": mesh_name, "chips": chips}
    t0 = time.time()
    try:
        dist = DistConfig(data_axes=axes.data, model_axis="model")
        step = make_sharded_step(comm, dist, udt_kw(n_bins, max_nodes),
                                 num_slots)
        m = m_examples // comm.shards(dist.data_axes)
        k = k_feats // comm.axis_size("model")
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = udt_inputs(m, k, n_bins, n_classes, num_slots, max_nodes)
            counts = analysis.count(step, *args, comm=comm)
        row.update(analysis.analyze(counts, chips))
        row["lower_compile_s"] = round(time.time() - t0, 1)
        row["collective_calls"] = collective_calls(counts["log"])
        row["status"] = "OK"
    except Exception as e:
        row["status"] = f"FAIL({type(e).__name__}: {e})"
        row["traceback"] = traceback.format_exc()[-2000:]
    if verbose:
        print(f"[{mesh_name}] udt_paper: {row['status']}", flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--skip-udt", action="store_true")
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if args.arch == "all" else [
        configs.ALIASES.get(args.arch, args.arch)]
    shapes = list(configs.SHAPES) if args.shape == "all" else [args.shape]
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append("16x16")
    if args.mesh in ("multi", "both"):
        meshes.append("2x16x16")

    t0 = time.time()
    rows = []
    for mesh_name in meshes:
        for arch in archs:
            for shape_id in shapes:
                rows.append(run_cell(arch, shape_id, mesh_name))
        if not args.skip_udt:
            rows.append(run_udt_cell(mesh_name))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1, default=str)
    n_ok = sum(r["status"] == "OK" for r in rows)
    n_skip = sum(r["status"].startswith("SKIP") for r in rows)
    n_fail = len(rows) - n_ok - n_skip
    print(f"\n{n_ok} OK / {n_skip} SKIP / {n_fail} FAIL -> {args.out} "
          f"({time.time() - t0:.0f} s)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
