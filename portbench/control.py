"""The control of a cell: the plain reference put in the program's place,
computed one precision below the configuration's, and held by the cell's
own check, which has to refuse it.

    python3 portbench/control.py --workload <cell> --seed <n> [--dtype bfloat16]

The configurations state float32 (split scores, gradients, sums of
weights), so the control runs in bfloat16: the tree's histograms and
scores, and for boosting the rounds' score updates; the TOOT grid sums its
counts in bfloat16.  Prints one JSON line with the check's numbers and
their limits.  The benchmark's own runs never run this; a test under
``tests/`` runs it at a small size on the CPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import types

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def control_fit_tune(job, dtype):
    import torch
    from portbench.reference import binning, toot, tree as rt
    d, tc = job.cfg["data"], job.cfg["tree"]
    job.draw()
    bins, n_num, n_cat, n_bins = binning.bin_columns(job.cols, d["max_num_bins"])
    job.table = types.SimpleNamespace(bins=bins, n_num=n_num, n_cat=n_cat,
                                      n_bins=n_bins)
    dev = job.device
    stats = torch.nn.functional.one_hot(
        torch.as_tensor(job.y_tr, device=dev).long(), job.n_classes)
    rules = rt.Rules("class", tc["max_depth"], tc["min_samples_split"],
                     tc["min_samples_leaf"])
    tree = rt.grow(torch.as_tensor(bins[job.tr], device=dev), stats,
                   torch.as_tensor(n_num), torch.as_tensor(n_cat), n_bins,
                   rules, dtype)
    dmax, smin = toot.paper_axes(int(tree["depth"].max()), len(job.y_tr))
    counts = toot.grid_correct(tree, torch.as_tensor(bins[job.va], device=dev),
                               job.y_va, n_num, dmax, smin, dtype=dtype)
    metric = (counts.double() / len(job.y_va)).cpu().numpy()[:, :, None]
    flat = int(np.argmax(metric))
    i, j, _ = np.unravel_index(flat, metric.shape)
    best = types.SimpleNamespace(metric=float(metric.max()), config={
        "max_depth": int(dmax[i]), "min_samples_split": int(smin[j])})
    job.kept_tree, job.kept_sweep, job.kept_index = tree, (metric, best), 0
    job.jobs = [(len(tree["depth"]), best.metric,
                 tuple(sorted(best.config.items())))]


def control_boost(job, dtype):
    import torch
    from portbench.reference import boost, tree as rt
    mdl, tc = job.cfg["model"], job.cfg["tree"]
    job.draw()
    n_num, n_cat = torch.as_tensor(job.n_num), torch.as_tensor(job.n_cat)
    rules = rt.Rules("moment", tc["max_depth"], tc["min_samples_split"],
                     tc["min_samples_leaf"], tc["min_child_weight"])
    trees = boost.fit(job.bins, job.y, n_num, n_cat, job.n_bins,
                      rounds=int(mdl["rounds"]), lr=mdl["learning_rate"],
                      goss=boost.Goss(**mdl["goss"]), seed=job.seed,
                      rules=rules, dtype=dtype)
    job.trees, job.kept_index = trees, 0
    job.fits = [tuple(len(t["depth"]) for t in trees)]
    n = min(int(job.cfg["check"]["raw_rows"]), job.bins.shape[0])
    job.raw_rows = torch.as_tensor(
        np.sort(job.rng.choice(job.bins.shape[0], n, replace=False)),
        device=job.device)
    sample = job.bins[job.raw_rows]
    raw = boost.base_score(job.y).to(dtype).expand(n)
    for t in trees:
        tt = {k: torch.as_tensor(np.asarray(v), device=job.device)
              for k, v in t.items()}
        raw = raw + (mdl["learning_rate"]
                     * rt.walk(tt, sample, n_num, tc["max_depth"])).to(dtype)
    job.raw_port = raw.float()


CONTROLS = {"fit_tune": control_fit_tune, "boost": control_boost}


def run_control(workload: str, seed: int, dtype_name: str, device,
                config_override=None) -> dict:
    import torch
    from portbench import harness, trace
    cell = harness.load_cell(workload)
    config = config_override or harness.load_config(cell["config"])
    job = harness.job_class(cell["job"])(config=config, cell=cell, seed=seed,
                                         device=device, spans=trace.Spans())
    CONTROLS[cell["job"]](job, getattr(torch, dtype_name))
    checks, failed = job.check(1)
    return {"workload": workload, "seed": seed, "dtype": dtype_name,
            "failed": failed,
            "correct": failed == 0 and all(v <= lim for v, lim in checks.values()),
            "checks": {k: [float(v), float(lim)] for k, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 3
    print(json.dumps(run_control(args.workload, args.seed, args.dtype,
                                 torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
