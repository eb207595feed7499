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


def run_world(tmp: pathlib.Path, shape, names, cases, data_path,
              timeout=120.0):
    """Run ``cases`` on a ``shape`` world; returns (trees of rank 0 as
    ``{case: [tree dict, ...]}``, every rank's collective counts, by
    rank).  Every rank's trees must equal rank 0's."""
    tmp.mkdir(parents=True, exist_ok=True)
    world = math.prod(shape)
    spec = dict(store=f"file://{tmp / 'store'}", shape=list(shape),
                names=list(names), data=str(data_path), out=str(tmp / "out"),
                cases=cases)
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r),
                               str(world), str(tmp / "spec.json")], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        tails = "\n".join(f"--- rank {r} (rc {rc})\n"
                          + (tmp / f"rank{r}.log").read_text()[-3000:]
                          for r, rc in enumerate(rcs) if rc)
        raise AssertionError(f"world {tuple(shape)} failed or passed its "
                             f"{timeout:.0f} s deadline:\n{tails}")
    ranks = [dict(np.load(tmp / f"out{r}.npz")) for r in range(world)]
    for r in range(1, world):
        assert ranks[r].keys() == ranks[0].keys()
        for key, v in ranks[0].items():
            np.testing.assert_array_equal(ranks[r][key], v,
                                          err_msg=f"rank {r} {key}")
    trees = {}
    for key, v in ranks[0].items():
        case, i, field = key.split("/")
        trees.setdefault(case, {}).setdefault(int(i), {})[field] = v
    counts = [json.loads((tmp / f"out{r}.json").read_text())
              for r in range(world)]
    return ({c: [t[i] for i in sorted(t)] for c, t in trees.items()},
            counts)
