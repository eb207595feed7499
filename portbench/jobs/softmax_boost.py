"""Closed-loop fits of multiclass softmax boosting on a binned table.

Set-up draws the raw table in an order drawn from the seed (as
``fit_tune``), bins it with the program's ``fit_bins``, puts the training
rows' bin codes on the device and runs one 2-round warm-up fit that builds
every kernel.  A unit is one whole fit of the configured rounds through
``GradientBoostedTrees(loss="softmax").fit``; the end-to-end metric divides
the elapsed time by the rounds completed.  The check holds three rounds of
the last fit drawn from the seed (the first, the last in which a
class-tree grew past its root, and one between), every class-tree node by
node, and its raw scores on the validation rows against the plain
references; every other fit must have grown trees of the same sizes.  ``control`` puts the plain reference, in a dtype of the
caller's choice, in the program's place for the same check.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.jobs import fit_tune
from portbench.jobs.fit_tune import tree_numpy
from portbench.reference import binning as ref_binning
from portbench.reference import softmax as ref_softmax
from portbench.reference import tree as ref_tree
from portbench.reference.boost import moment_stats
from portbench.work_softmax import round_extra_bytes, round_rows, round_work

__all__ = ["Job", "control"]


class Job:
    profile_units = 1
    draw = fit_tune.Job.draw        # the table, its split and the seed's order

    def __init__(self, *, config, cell, seed, device, spans):
        self.cfg = config
        self.seed = int(seed)
        self.device = device
        self.spans = spans
        self.counters = {}
        self.fits = []              # tree sizes of each fit
        self.kept = None            # (index, model) of the last fit
        self.rng = np.random.default_rng(self.seed)
        self.rounds_per_unit = int(config["model"]["rounds"])

    def _model(self, rounds: int):
        from repro_torch.core import GradientBoostedTrees, TreeConfig
        mdl = self.cfg["model"]
        return GradientBoostedTrees(
            n_trees=rounds, learning_rate=mdl["learning_rate"],
            config=TreeConfig(**self.cfg["tree"]), goss=None,
            loss=mdl["loss"], seed=self.seed)

    def _place(self, bins, n_num, n_cat, n_bins):
        """The training and validation bin codes on the device."""
        self.bins_tr = torch.as_tensor(np.asarray(bins)[self.tr],
                                       device=self.device)
        self.bins_va = torch.as_tensor(np.asarray(bins)[self.va],
                                       device=self.device)
        self.n_num = np.asarray(n_num, np.int32)
        self.n_cat = np.asarray(n_cat, np.int32)
        self.n_bins = int(n_bins)

    def setup(self):
        from repro_torch.core import BinnedTable, fit_bins
        self.draw()
        with self.spans.span("fit_bins"):
            t = fit_bins(self.cols, max_num_bins=self.cfg["data"]["max_num_bins"])
        self._place(t.bins, t.n_num, t.n_cat, t.n_bins)
        self.train = BinnedTable(bins=self.bins_tr, n_num=t.n_num,
                                 n_cat=t.n_cat, metas=t.metas, n_bins=t.n_bins)
        with self.spans.span("warmup"):
            self._fit(2)
        self.fits.clear()

    def _fit(self, rounds: int):
        # the previous fit is let go first, so that every fit finds the
        # memory the one before it freed; the last fit is the one checked
        self.kept = None
        with torch.profiler.record_function("portbench.fit"):
            with self.spans.span("fit"):
                model = self._model(rounds).fit(self.train, self.y_tr,
                                                device=self.device)
        self.fits.append(tuple(t.n_nodes for t in model.trees))
        self.kept = (len(self.fits) - 1, model)

    def unit(self):
        self._fit(self.rounds_per_unit)

    def profiled(self):
        self._fit(self.rounds_per_unit)

    def end_to_end(self, window_s, units):
        return {"boost_round_ms": 1e3 * window_s / (units * self.rounds_per_unit)}

    def release(self):
        idx, model = self.kept
        self.kept = None
        self.kept_index = idx
        self.trees = [tree_numpy(t) for t in model.trees]
        self.raw_port = model.predict_raw_device(self.bins_va).float()
        del model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, units):
        mdl, tc, lim = self.cfg["model"], self.cfg["tree"], self.cfg["limits"]
        n_cls = self.n_classes
        dev = self.device
        r_all = len(self.trees) // n_cls
        # the last round in which a class-tree grew past its root, and one
        # drawn before it: later rounds may be all single leaves
        last = max([r for r in range(r_all) if any(
            len(t["depth"]) > 1 for t in self.trees[r * n_cls:(r + 1) * n_cls])]
            or [r_all - 1])
        judged = sorted({0, last, int(self.rng.integers(1, max(2, last)))}
                        & set(range(last + 1)))
        rules = ref_tree.Rules("moment", tc["max_depth"],
                               tc.get("min_samples_split", 2),
                               tc.get("min_samples_leaf", 1),
                               tc.get("min_child_weight", 0.0))
        n_num = torch.as_tensor(self.n_num)
        n_cat = torch.as_tensor(self.n_cat)
        y = torch.as_tensor(self.y_tr, device=dev).long()
        res = dict(node_mismatch=0, rule_violations=0, label_gap=0.0,
                   gain_gap=0.0)
        self.rows_per_node = [None] * len(self.trees)
        self.launch_rows = [None] * r_all

        def visit(r, z, h):
            ids = slice(r * n_cls, (r + 1) * n_cls)
            rows, self.launch_rows[r] = round_rows(
                self.trees[ids], self.bins_tr, n_num, tc["max_depth"])
            self.rows_per_node[ids] = rows
            if r not in judged:
                return
            for c, tree in enumerate(self.trees[ids]):
                j = ref_tree.judge(tree, self.bins_tr,
                                   moment_stats(z[c], h[c], torch.float64),
                                   n_num, n_cat, self.n_bins, rules,
                                   tol=float(self.cfg["check"]["rule_margin"]))
                for k in ("node_mismatch", "rule_violations"):
                    res[k] += j[k]
                res["gain_gap"] = max(res["gain_gap"], j["gain_gap"])
                res["label_gap"] = max(res["label_gap"], ref_softmax.label_gap(
                    tree, self.bins_tr, n_num, z[c], h[c], tc["max_depth"]))

        ref_softmax.replay(self.trees, self.bins_tr, y, n_num, n_classes=n_cls,
                           lr=mdl["learning_rate"], steps=tc["max_depth"],
                           visit=visit)
        ref = ref_softmax.raw_scores(
            self.trees, self.bins_va, n_num,
            ref_softmax.base_score(y, n_cls), n_classes=n_cls,
            lr=mdl["learning_rate"], steps=tc["max_depth"],
            dtype=torch.float64).T
        raw_gap = float(((self.raw_port.double() - ref).abs()
                         / (1.0 + ref.abs())).max())
        differing = sum(1 for s in self.fits if s != self.fits[self.kept_index])
        fit_s = self.spans.durations_within("fit", "window")
        sizes = [len(t["depth"]) for t in self.trees]
        self.counters.update(fits=units, fits_differing=differing,
                             fit_s=[round(x, 4) for x in fit_s],
                             judged_rounds=judged,
                             tree_nodes_by_class=[sizes[c::n_cls]
                                                  for c in range(n_cls)])
        checks = {
            "node_mismatch": (res["node_mismatch"], 0),
            "rule_violations": (res["rule_violations"], 0),
            "label_gap": (res["label_gap"], lim["label_gap"]),
            "gain_gap": (res["gain_gap"], lim["gain_gap"]),
            "raw_gap": (raw_gap, lim["raw_gap"]),
            "fits_differing": (differing, 0),
        }
        bad_kept = any(not (v <= l) for v, l in checks.values())
        return checks, differing + int(bad_kept)

    def work(self) -> dict:
        """Counted work of one round (``work_softmax.py``), averaged over
        the checked fit's rounds."""
        d = self.cfg["data"]
        n_cls = self.n_classes
        r_all = len(self.trees) // n_cls
        tot: dict = {}
        for r in range(r_all):
            ids = slice(r * n_cls, (r + 1) * n_cls)
            w = round_work(self.trees[ids], self.rows_per_node[ids],
                           self.launch_rows[r], n_features=d["features"],
                           n_bins=self.n_bins)
            for k, v in w.items():
                tot[k] = tot.get(k, 0) + v
        out = {k: v / r_all for k, v in tot.items()}
        out["table_bytes"] = round_extra_bytes(len(self.y_tr), n_cls,
                                               self.cfg["tree"]["max_depth"])
        out["total_bytes"] = (out["hist_bytes"] + out["select_bytes"]
                              + out["route_bytes"] + out["table_bytes"])
        out["total_ops"] = out["hist_ops"] + out["select_ops"]
        return out


def control(job, dtype):
    """The plain reference in the program's place: the reference's bins
    and a fit grown with sums and scores in ``dtype``, left where
    ``release`` leaves the program's, for ``job.check``."""
    mdl, tc, d = job.cfg["model"], job.cfg["tree"], job.cfg["data"]
    job.draw()
    bins, n_num, n_cat, n_bins = ref_binning.bin_columns(job.cols,
                                                         d["max_num_bins"])
    job._place(bins, n_num, n_cat, n_bins)
    n_num, n_cat = torch.as_tensor(job.n_num), torch.as_tensor(job.n_cat)
    rules = ref_tree.Rules("moment", tc["max_depth"], tc["min_samples_split"],
                           tc["min_samples_leaf"], tc["min_child_weight"])
    y = torch.as_tensor(job.y_tr, device=job.device).long()
    trees = ref_softmax.fit(job.bins_tr, y, n_num, n_cat, job.n_bins,
                            n_classes=job.n_classes, rounds=int(mdl["rounds"]),
                            lr=mdl["learning_rate"], rules=rules, dtype=dtype)
    job.trees, job.kept_index = trees, 0
    job.fits = [tuple(len(t["depth"]) for t in trees)]
    job.raw_port = ref_softmax.raw_scores(
        trees, job.bins_va, n_num, ref_softmax.base_score(y, job.n_classes),
        n_classes=job.n_classes, lr=mdl["learning_rate"],
        steps=tc["max_depth"], dtype=dtype).T.float()
