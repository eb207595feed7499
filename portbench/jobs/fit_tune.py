"""Closed-loop UDT fit-and-tune jobs on a binned table.

Set-up draws the raw table, in an order drawn from the seed, bins it with
the program's ``fit_bins`` (the paper's no-pre-encoding path), splits the
rows and runs one warm-up job.  A job: ``build_tree`` on the training rows, then
``sweep`` of the paper's TOOT protocol on the validation rows, then the
best cell read back on the host.  The check holds the bins, one job's tree
drawn from the seed and its sweep against the plain references.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.data.kdd99 import split_rows, synth_kdd99
from portbench.reference import binning as ref_binning
from portbench.reference import toot as ref_toot
from portbench.reference import tree as ref_tree
from portbench.work import tree_work

__all__ = ["Job"]

TREE_FIELDS = ("feat", "op", "tbin", "label", "count", "depth", "left",
               "right", "leaf")


def tree_numpy(tree) -> dict:
    """The program's tree as numpy fields of its ``n_nodes`` nodes."""
    return {f: getattr(tree, f)[:tree.n_nodes].cpu().numpy()
            for f in TREE_FIELDS}


class Job:
    rounds_per_unit = 1
    profile_units = 3

    def __init__(self, *, config, cell, seed, device, spans):
        self.cfg = config
        self.seed = int(seed)
        self.device = device
        self.spans = spans
        self.counters = {}
        self.jobs = []              # (n_nodes, best metric, best config)
        self.kept = None            # (index, tree, sweep result) of one job
        self.rng = np.random.default_rng(self.seed)

    # -- set-up ------------------------------------------------------------
    def draw(self):
        """The raw table in an order drawn from the seed: the table and its
        training / validation split come from the configuration's
        ``table_seed``, so every seed does the same work; the seed orders
        the training rows, then the validation rows."""
        d = self.cfg["data"]
        with self.spans.span("make_data"):
            cols, y = synth_kdd99(d["rows"], d["table_seed"])
            tr, va = split_rows(d["rows"], d["table_seed"] + 1,
                                d["val_fraction"])
            rng = np.random.default_rng(self.seed)
            order = np.concatenate([rng.permutation(tr), rng.permutation(va)])
            self.cols = [np.asarray(c)[order] for c in cols]
            self.y = y[order]
        self.tr = np.arange(len(tr))
        self.va = np.arange(len(tr), len(order))
        self.y_tr, self.y_va = self.y[self.tr], self.y[self.va]
        self.n_classes = int(d["classes"])

    def setup(self):
        from repro_torch.core import BinnedTable, TreeConfig, fit_bins
        self.draw()
        with self.spans.span("fit_bins"):
            self.table = fit_bins(self.cols,
                                  max_num_bins=self.cfg["data"]["max_num_bins"])
        tr, va = self.tr, self.va
        t = self.table
        self.train = BinnedTable(bins=t.bins[tr], n_num=t.n_num, n_cat=t.n_cat,
                                 metas=t.metas, n_bins=t.n_bins)
        self.val_bins = t.bins[va]
        self.tree_config = TreeConfig(**self.cfg["tree"])
        with self.spans.span("warmup"):
            self._job()
        self.jobs.clear()
        self.kept = None

    # -- the unit of work --------------------------------------------------
    def _job(self):
        from repro_torch.core import build_tree, sweep
        with torch.profiler.record_function("portbench.build"):
            with self.spans.span("build"):
                tree = build_tree(self.train, self.y_tr, self.tree_config,
                                  n_classes=self.n_classes, device=self.device)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        with torch.profiler.record_function("portbench.sweep"):
            with self.spans.span("sweep"):
                res = sweep(tree, self.val_bins, self.y_va, self.table.n_num,
                            train_size=len(self.y_tr), device=self.device)
                best = res.best
        self.jobs.append((tree.n_nodes, best.metric,
                          tuple(sorted(best.config.items()))))
        # one job kept for the check, drawn from the seed (reservoir)
        if self.rng.random() * len(self.jobs) < 1.0:
            self.kept = (len(self.jobs) - 1, tree, res)

    def unit(self):
        self._job()

    def profiled(self):
        for _ in range(self.profile_units):
            self._job()

    def end_to_end(self, window_s, units):
        return {"udt_job_ms": 1e3 * window_s / units}

    # -- after the window --------------------------------------------------
    def release(self):
        idx, tree, res = self.kept
        self.kept_tree = tree_numpy(tree)
        self.kept_sweep = (np.asarray(res.metric), res.best)
        self.kept_index = idx
        self.kept = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, units):
        """``({name: (value, limit)}, failed jobs)``."""
        lim = self.cfg["limits"]
        d = self.cfg["data"]
        dev = self.device
        bins, n_num, n_cat, n_bins = ref_binning.bin_columns(
            self.cols, d["max_num_bins"])
        t = self.table
        bins_bad = int((bins != t.bins).sum()) if bins.shape == t.bins.shape \
            else bins.size
        bins_bad += int((n_num != t.n_num).sum() + (n_cat != t.n_cat).sum()
                        + (n_bins != t.n_bins))
        tree = self.kept_tree
        tr_bins = torch.as_tensor(bins[self.tr], device=dev)
        stats = torch.nn.functional.one_hot(
            torch.as_tensor(self.y_tr, device=dev).long(),
            self.n_classes).to(torch.float64)
        tc = self.cfg["tree"]
        rules = ref_tree.Rules("class", tc["max_depth"], tc["min_samples_split"],
                               tc["min_samples_leaf"],
                               tc.get("min_child_weight", 0.0))
        j = ref_tree.judge(tree, tr_bins, stats, torch.as_tensor(n_num),
                           torch.as_tensor(n_cat), n_bins, rules)
        self.rows_per_node = j["rows_per_node"]
        metric, best = self.kept_sweep
        dmax, smin = ref_toot.paper_axes(int(tree["depth"].max()), len(self.y_tr))
        counts = ref_toot.grid_correct(
            tree, torch.as_tensor(bins[self.va], device=dev), self.y_va,
            n_num, dmax, smin).cpu().numpy()
        ref_metric = counts.astype(np.float64) / len(self.y_va)
        if metric.shape[:2] == ref_metric.shape and metric.shape[2] == 1:
            toot_bad = int((metric[:, :, 0] != ref_metric).sum())
        else:
            toot_bad = ref_metric.size
        cfg_best = best.config
        di = np.nonzero(dmax == cfg_best["max_depth"])[0]
        si = np.nonzero(smin == cfg_best["min_samples_split"])[0]
        if (best.metric != ref_metric.max() or not len(di) or not len(si)
                or ref_metric[di[0], si[0]] != ref_metric.max()):
            toot_bad += 1
        differing = sum(1 for s in self.jobs if s != self.jobs[self.kept_index])
        q = {name: np.percentile(d, [10, 50, 90]).round(5).tolist() if d else []
             for name in ("build", "sweep")
             for d in [self.spans.durations_within(name, "window")]}
        self.counters.update(jobs=units, jobs_differing=differing,
                             build_s_p10_50_90=q["build"],
                             sweep_s_p10_50_90=q["sweep"],
                             tree_nodes=len(tree["depth"]),
                             tree_depth=int(tree["depth"].max()))
        checks = {
            "bins_mismatch": (bins_bad, 0),
            "node_mismatch": (j["node_mismatch"], 0),
            "rule_violations": (j["rule_violations"], 0),
            "gain_gap": (j["gain_gap"], lim["gain_gap"]),
            "toot_mismatch": (toot_bad, 0),
            "jobs_differing": (differing, 0),
        }
        bad_kept = any(not (v <= l) for v, l in checks.values())
        return checks, differing + int(bad_kept or not np.isfinite(j["gain_gap"]))

    def work(self) -> dict:
        """Counted work of one job (``work.py``)."""
        tree = self.kept_tree
        d = self.cfg["data"]
        w = tree_work(tree, self.rows_per_node, n_features=d["features"],
                      n_bins=int(self.table.n_bins), channels=self.n_classes,
                      weighted=False)
        t_len = int(tree["depth"].max())
        w["toot_bytes"] = len(self.y_va) * t_len * 8
        w["total_bytes"] = (w["hist_bytes"] + w["select_bytes"]
                            + w["route_bytes"] + w["toot_bytes"])
        w["total_ops"] = w["hist_ops"] + w["select_ops"]
        return w
