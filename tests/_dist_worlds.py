"""Multi-rank worlds of the port's sharded build, for the CPU tests.

A world is N ``subprocess.Popen`` ranks (gloo over a ``file://`` store in
the test's temporary directory, so parallel test workers never race for a
port), each running ``RANK_SCRIPT`` on a ``DeviceMesh`` of the given shape.
The ranks read their problems from an npz, build every case with
``DistributedBuilder`` and each write their trees and collective counts;
``run_world`` waits on every rank with one deadline and kills the world
when it passes, so a hung collective fails the test instead of stalling
the suite."""
from __future__ import annotations

import json
import math
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
FIELDS = ("feat", "op", "tbin", "score", "label", "count", "depth", "left",
          "right", "leaf", "parent")

RANK_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.core import TreeConfig
from repro_torch.core.binning import BinnedTable
from repro_torch.core.distributed import DistConfig, DistributedBuilder

torch.set_num_threads(1)
rank, world, spec = int(sys.argv[1]), int(sys.argv[2]), json.load(open(sys.argv[3]))
tdist.init_process_group("gloo", init_method=spec["store"], rank=rank,
                         world_size=world)
try:
    mesh = init_device_mesh("cpu", tuple(spec["shape"]),
                            mesh_dim_names=tuple(spec["names"]))
    data = np.load(spec["data"])
    out, counts = {}, {}
    # the collectives themselves: psum / pmax over each axis against the
    # group's ranks, and a reduce-scatter over every axis (this rank keeps
    # the block at its mesh-major index) gathered back to the psum
    from repro_torch.core.collectives import Collectives
    comm = Collectives(mesh)
    x = torch.arange(8 * world, dtype=torch.float32)[:, None] + 100 * rank
    for ax in spec["names"]:
        ids = comm.all_gather(torch.tensor([rank]), (ax,), "t").tolist()
        assert len(ids) == comm.axis_size(ax)
        assert ids[comm.axis_index(ax)] == rank
        want = sum(torch.arange(8 * world)[:, None] + 100 * r for r in ids)
        assert torch.equal(comm.psum(x, (ax,), "t"), want.float())
        assert torch.equal(comm.pmax(x, (ax,), "t"), x - 100 * rank
                           + 100 * max(ids))
    axes = tuple(spec["names"])
    assert comm.data_index(axes) == rank
    total = comm.psum(x, axes, "t")
    mine = comm.psum_scatter(x, axes, "t")
    assert torch.equal(mine, total[8 * rank:8 * rank + 8])
    assert torch.equal(comm.all_gather(mine, axes, "t"), total)
    got = comm.all_gather_many([x[:, 0], (x[:, 0] > 3), x[:, 0].int()],
                               axes, "t")
    assert torch.equal(got[0], torch.cat([torch.arange(8 * world) + 100 * r
                                          for r in range(world)]).float())
    counts["collectives"] = {"ok": 1}
    for case in spec["cases"]:
        p = case["problem"]
        table = BinnedTable(bins=data[p + "/bins"], n_num=data[p + "/n_num"],
                            n_cat=data[p + "/n_cat"], metas=[],
                            n_bins=int(data[p + "/n_bins"]))
        dist = DistConfig(**dict(case["dist"],
                                 data_axes=tuple(case["dist"]["data_axes"])))
        b = DistributedBuilder(table, TreeConfig(**case["cfg"]), mesh=mesh,
                               dist=dist, n_classes=case.get("n_classes"),
                               device="cpu")
        w = data[case["weights"]] if case.get("weights") else None
        if case.get("batched"):
            trees, _ = b.build_batched(data[case["y"]], sample_weight=w)
        else:
            trees = [b.build(data[case["y"]], sample_weight=w)]
        for i, t in enumerate(trees):
            key = f"{case['name']}/{i}/"
            out[key + "n_nodes"] = np.int64(t.n_nodes)
            for f in %(fields)r:
                out[key + f] = getattr(t, f)[:t.n_nodes].numpy()
        counts[case["name"]] = {f"{op}/{tag}": v
                                for (op, tag), v in b.comm.counts.items()}
    np.savez(f"{spec['out']}{rank}.npz", **out)
    with open(f"{spec['out']}{rank}.json", "w") as fh:
        json.dump(counts, fh)
finally:
    tdist.destroy_process_group()
""" % {"fields": FIELDS}


FIT_SCRIPT = r"""
import json, os, signal, sys
import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.checkpoint import CheckpointMismatchError, RoundCheckpointer
from repro_torch.core import (GossConfig, GradientBoostedTrees, RandomForest,
                              SweepSpace, TreeConfig, build_tree, get_loss,
                              sweep)
from repro_torch.core import forest
from repro_torch.core.binning import BinnedTable
from repro_torch.core.collectives import Collectives
from repro_torch.core.distributed import (DistConfig, make_sharded_sampler,
                                          make_sharded_walk)
from repro_torch.resilience import chain, kill_at_round

torch.set_num_threads(1)
rank, world, spec = int(sys.argv[1]), int(sys.argv[2]), json.load(open(sys.argv[3]))
tdist.init_process_group("gloo", init_method=spec["store"], rank=rank,
                         world_size=world)
data = np.load(spec["data"])
seed_draw = forest._shard_uniforms


def table(p):
    return BinnedTable(bins=data[p + "/bins"], n_num=data[p + "/n_num"],
                       n_cat=data[p + "/n_cat"], metas=[],
                       n_bins=int(data[p + "/n_bins"]))


def uniforms(key, seed):
    # the reference's per-shard draws U[round, shard] in place of the
    # port's: round r's seed is the r-th draw of the fit's generator
    u = torch.from_numpy(data[key])
    gen = torch.Generator().manual_seed(seed)
    rounds = {forest._round_seed(gen): r for r in range(u.shape[0])}
    return lambda rs, shard, m_loc, device: u[rounds[rs], shard].to(device)


def estimator(case):
    return GradientBoostedTrees(
        n_trees=case["n_trees"], learning_rate=0.3,
        config=TreeConfig(**case["cfg"]),
        goss=GossConfig(*case["goss"]) if case.get("goss") else None,
        loss=case["loss"], seed=case["seed"])


def fit(case, t, y, **kw):
    roots = []

    def root(state):               # each tree's first level: the selection
        if state.depth == 2:
            a = state.assign
            roots.append((a if a.dim() == 1 else a[0]).numpy() >= 0)

    sw = data[case["weights"]] if case.get("weights") else None
    ens = estimator(case).fit(t, y, sample_weight=sw, mesh=mesh, dist=dist,
                              device="cpu", level_callback=root, **kw)
    return ens, np.stack(roots)


try:
    mesh = init_device_mesh("cpu", tuple(spec["shape"]),
                            mesh_dim_names=tuple(spec["names"]))
    out, counts = {}, {}
    for case in spec["cases"]:
        name, kind = case["name"], case["kind"]
        t, y = table(case["problem"]), data[case["y"]]
        dist = DistConfig(**dict(case.get("dist", {}), data_axes=tuple(
            case.get("dist", {}).get("data_axes", ["data"]))))
        forest._shard_uniforms = (uniforms(case["uniforms"], case["seed"])
                                  if case.get("uniforms") else seed_draw)
        if kind == "sampler":
            comm = Collectives(mesh)
            comm.log = []
            lo = get_loss(case["loss"])
            goss = GossConfig(*case["goss"])
            m = len(y)
            d = comm.shards(dist.data_axes)
            m_loc = -(-m // d)
            r0 = comm.data_index(dist.data_axes) * m_loc
            blk = lambda x: torch.as_tensor(np.pad(
                x, [(0, d * m_loc - m)] + [(0, 0)] * (x.ndim - 1))[
                    r0:r0 + m_loc])
            fn = make_sharded_sampler(comm, dist, lo, goss, m,
                                      *goss.shard_quota(m, d))
            z, w, a0 = fn(blk(y), blk(data[case["raw"]]), case["round_seed"])
            out[name + "/local/w"] = w.numpy()
            out[name + "/local/assign0"] = a0.numpy()
            counts[name] = [list(e[:3]) for e in comm.log]
            comm.log = []
            ens = estimator(case).fit(t, y, device="cpu")
            walk = make_sharded_walk(comm, dist, case["cfg"]["max_depth"])
            k = t.bins.shape[1] // comm.shards(
                () if dist.model_axis is None else (dist.model_axis,))
            f0 = (comm.axis_index(dist.model_axis) * k
                  if dist.model_axis else 0)
            raw = walk(torch.zeros(m_loc), ens.trees[0]._asdict(),
                       blk(t.bins)[:, f0:f0 + k].contiguous(),
                       torch.as_tensor(t.n_num[f0:f0 + k]), torch.tensor(1.0))
            out[name + "/local/walk"] = raw.numpy()
            counts[name + "/walk"] = [list(e[:3]) for e in comm.log]
        elif kind == "gbt":
            ens, roots = fit(case, t, y)
            out[name + "/raw"] = ens.predict_raw(t.bins)
            out[name + "/local/roots"] = roots
            for i, tr in enumerate(ens.trees):
                for f in ("feat", "tbin", "left", "right", "label"):
                    out[f"{name}/tree{i}/{f}"] = getattr(tr, f)[:tr.n_nodes].numpy()
            counts[name] = {f"{op}/{tag}": v
                            for (op, tag), v in ens.collective_counts.items()}
            if case.get("repeat"):
                again, _ = fit(case, t, y)
                out[name + "/raw_again"] = again.predict_raw(t.bins)
                try:
                    sweep(ens, t.bins, y, mesh=mesh, dist=dist, device="cpu")
                except ValueError as e:
                    out[name + "/sweep_refused"] = np.int64("single trees" in str(e))
        elif kind == "forest":
            rf = RandomForest(n_trees=case["n_trees"], max_features=0.7,
                              config=TreeConfig(**case["cfg"]), seed=case["seed"])
            rf.fit(t, y, mesh=mesh, dist=dist, device="cpu")
            for i, tr in enumerate(rf.trees):
                out[f"{name}/tree{i}/n_nodes"] = np.int64(tr.n_nodes)
                for f in %(fields)r:
                    out[f"{name}/tree{i}/{f}"] = getattr(tr, f)[:tr.n_nodes].numpy()
            out[name + "/votes"] = rf.predict_raw(t.bins)
        elif kind == "sweep":
            tree = build_tree(t, y, TreeConfig(**case["cfg"]), device="cpu")
            vb, yv = data[case["val"] + "/bins"], data[case["val_y"]]
            space = SweepSpace(mcw_values=tuple(case["mcw"]))
            res = sweep(tree, vb, yv, t.n_num, space=space, mesh=mesh,
                        dist=dist, device="cpu")
            for f in ("metric", "n_nodes", "walk_bytes", "dmax", "smin"):
                out[f"{name}/{f}"] = np.asarray(getattr(res, f))
        elif kind == "kill":
            fit(case, t, y, round_callback=chain(
                RoundCheckpointer(case["ckpt"]), lambda s: tdist.barrier(),
                kill_at_round(case["kill_at"])))
            raise SystemExit("survived the kill round")
        elif kind == "resume":
            full, _ = fit(case, t, y)
            resumed, _ = fit(case, t, y, resume_from=case["ckpt"])
            out[name + "/raw"] = full.predict_raw(t.bins)
            out[name + "/raw_resumed"] = resumed.predict_raw(t.bins)
            out[name + "/trees_equal"] = np.int64(all(
                a.n_nodes == b.n_nodes and all(
                    torch.equal(getattr(a, f), getattr(b, f))
                    for f in %(fields)r)
                for a, b in zip(full.trees, resumed.trees)))
        elif kind == "mismatch":
            try:
                fit(case, t, y, resume_from=case["ckpt"])
                out[name + "/refused"] = np.int64(0)
            except CheckpointMismatchError:
                out[name + "/refused"] = np.int64(1)
    np.savez(f"{spec['out']}{rank}.npz", **out)
    with open(f"{spec['out']}{rank}.json", "w") as fh:
        json.dump(counts, fh)
finally:
    tdist.destroy_process_group()
""" % {"fields": FIELDS}


def start_world(tmp: pathlib.Path, shape, names, cases, data_path,
                script=RANK_SCRIPT, timeout=120.0):
    """Start a ``shape`` world of ``script`` ranks on ``cases``; returns the
    handle ``wait_world`` takes.  The deadline starts now."""
    tmp.mkdir(parents=True, exist_ok=True)
    world = math.prod(shape)
    spec = dict(store=f"file://{tmp / 'store'}", shape=list(shape),
                names=list(names), data=str(data_path), out=str(tmp / "out"),
                cases=cases)
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               str(world), str(tmp / "spec.json")], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    return dict(tmp=tmp, shape=tuple(shape), procs=procs, logs=logs,
                timeout=timeout, deadline=time.monotonic() + timeout)


def wait_world(handle, killed=False):
    """Wait for every rank of a started world with its one deadline, then
    kill whatever still runs, so a hung collective fails the test instead
    of stalling the suite.  Every rank must exit 0 (``killed``: every rank
    must end by SIGKILL).  Returns every rank's npz and JSON outputs (none
    for a killed world)."""
    procs, tmp = handle["procs"], handle["tmp"]
    try:
        for p in procs:
            p.wait(timeout=max(0.1, handle["deadline"] - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in handle["logs"]:
            fh.close()
    rcs = [p.returncode for p in procs]
    want = -signal.SIGKILL if killed else 0
    if any(rc != want for rc in rcs):
        tails = "\n".join(f"--- rank {r} (rc {rc})\n"
                          + (tmp / f"rank{r}.log").read_text()[-3000:]
                          for r, rc in enumerate(rcs) if rc != want)
        raise AssertionError(f"world {handle['shape']} failed or passed its "
                             f"{handle['timeout']:.0f} s deadline:\n{tails}")
    if killed:
        return None
    return ([dict(np.load(tmp / f"out{r}.npz")) for r in range(len(procs))],
            [json.loads((tmp / f"out{r}.json").read_text())
             for r in range(len(procs))])


def run_world(tmp: pathlib.Path, shape, names, cases, data_path,
              timeout=120.0):
    """Run ``cases`` on a ``shape`` world of ``RANK_SCRIPT``; returns (trees
    of rank 0 as ``{case: [tree dict, ...]}``, every rank's collective
    counts, by rank).  Every rank's trees must equal rank 0's."""
    ranks, counts = wait_world(start_world(tmp, shape, names, cases,
                                           data_path, timeout=timeout))
    for r in range(1, len(ranks)):
        assert ranks[r].keys() == ranks[0].keys()
        for key, v in ranks[0].items():
            np.testing.assert_array_equal(ranks[r][key], v,
                                          err_msg=f"rank {r} {key}")
    trees = {}
    for key, v in ranks[0].items():
        case, i, field = key.split("/")
        trees.setdefault(case, {}).setdefault(int(i), {})[field] = v
    return ({c: [t[i] for i in sorted(t)] for c, t in trees.items()},
            counts)
