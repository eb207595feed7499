"""Closed-loop UDT fit-and-tune jobs on the Covertype twin.

The job of ``fit_tune`` on another table: set-up draws the UCI Covertype
twin (``data/covertype.py``) in an order drawn from the seed, bins it with
the program's ``fit_bins`` and runs one warm-up job; a job is
``build_tree`` on the training rows, ``sweep`` of the paper's TOOT grid on
the validation rows and the best cell read back.  A fully grown tree here
has levels of thousands of nodes, so the check judges the kept tree with
the reference that works through a level in blocks of nodes
(``reference/wide_tree.py``).  The counters line adds the tree's shape,
the counted rows scattered, and the program's level-loop counters per
profiled job.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import inside
from portbench.data.covertype import synth_covertype
from portbench.data.kdd99 import split_rows
from portbench.jobs import fit_tune
from portbench.reference import binning as ref_binning
from portbench.reference import toot as ref_toot
from portbench.reference import tree as ref_tree
from portbench.reference import wide_tree

__all__ = ["Job"]


class Job(fit_tune.Job):
    def draw(self):
        """The twin and its training / validation split from the
        configuration's ``table_seed``; the seed orders the training rows,
        then the validation rows (as ``fit_tune``)."""
        d = self.cfg["data"]
        with self.spans.span("make_data"):
            cols, y = synth_covertype(d["rows"], d["table_seed"])
            tr, va = split_rows(d["rows"], d["table_seed"] + 1,
                                d["val_fraction"])
            rng = np.random.default_rng(self.seed)
            order = np.concatenate([rng.permutation(tr), rng.permutation(va)])
            self.cols = [c[order] for c in cols]
            self.y = y[order]
        self.tr = np.arange(len(tr))
        self.va = np.arange(len(tr), len(order))
        self.y_tr, self.y_va = self.y[self.tr], self.y[self.va]
        self.n_classes = int(d["classes"])

    def profiled(self):
        self.profiled_jobs = self.profile_units
        super().profiled()

    def check(self, units):
        """``({name: (value, limit)}, failed jobs)``: ``fit_tune``'s check,
        the kept tree judged a block of nodes at a time."""
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
        stats = torch.nn.functional.one_hot(
            torch.as_tensor(self.y_tr, device=dev).long(),
            self.n_classes).to(torch.float64)
        tc = self.cfg["tree"]
        rules = ref_tree.Rules("class", tc["max_depth"], tc["min_samples_split"],
                               tc["min_samples_leaf"])
        j = wide_tree.judge(tree, torch.as_tensor(bins[self.tr], device=dev),
                            stats, torch.as_tensor(n_num),
                            torch.as_tensor(n_cat), n_bins, rules)
        del stats
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
        di = np.nonzero(dmax == best.config["max_depth"])[0]
        si = np.nonzero(smin == best.config["min_samples_split"])[0]
        if (best.metric != ref_metric.max() or not len(di) or not len(si)
                or ref_metric[di[0], si[0]] != ref_metric.max()):
            toot_bad += 1
        differing = sum(1 for s in self.jobs if s != self.jobs[self.kept_index])
        q = {name: np.percentile(v, [10, 50, 90]).round(5).tolist() if v else []
             for name in ("build", "sweep")
             for v in [self.spans.durations_within(name, "window")]}
        widths = np.bincount(np.asarray(tree["depth"]))[1:]
        self.counters.update(jobs=units, jobs_differing=differing,
                             build_s_p10_50_90=q["build"],
                             sweep_s_p10_50_90=q["sweep"],
                             best_accuracy=float(best.metric),
                             fit_bins_s=sum(self.spans.durations("fit_bins")),
                             tree_nodes=len(tree["depth"]),
                             tree_depth=len(widths),
                             tree_widest=int(widths.max()),
                             rows_scattered=self.work()["rows_scattered"],
                             **self._program_counters())
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

    def _program_counters(self) -> dict:
        """The program's level-loop counters per profiled job, where a
        profile ran and the program counts them."""
        jobs = getattr(self, "profiled_jobs", 0)
        c = inside.program_counters() if jobs else None
        if c is None:
            return {}

        def per_job(name, span=None):
            v = c.get(name, {})
            return (sum(v.values()) if span is None else v.get(span, 0)) / jobs

        out = {"host_syncs": per_job("host_syncs"),
               "chunks": per_job("host_syncs", "tree.children")}
        slots = per_job("stack_slots")
        if slots:
            out["slot_fill"] = per_job("stack_slots_used") / slots
        if "levels_uncached" in c:
            out["levels_uncached"] = per_job("levels_uncached")
        return out
