"""Closed-loop fits of logistic GOSS boosting on a binned table on the card.

Set-up draws the bin codes and labels on the card from the seed (quantile
bins of continuous features are near-uniform codes) and runs one short
warm-up fit that builds every kernel.  A unit is one whole fit of the
configured rounds; the end-to-end metric divides the elapsed time by the
rounds completed.  The check holds rounds of one fit drawn from the seed
(the first, the last and one between) of the last fit, and its raw
scores on rows drawn from the seed, against the plain references; every
other fit must have grown trees of the same sizes.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.data.teacher import make_binned
from portbench.jobs.fit_tune import tree_numpy
from portbench.reference import boost as ref_boost
from portbench.reference import tree as ref_tree
from portbench.work import boost_round_extra, tree_work

__all__ = ["Job"]


class Job:
    profile_units = 1

    def __init__(self, *, config, cell, seed, device, spans):
        self.cfg = config
        self.seed = int(seed) % (1 << 63)
        self.device = device
        self.spans = spans
        self.counters = {}
        self.fits = []              # tree sizes of each fit
        self.kept = None            # (index, model) of one fit
        self.rng = np.random.default_rng(self.seed)
        self.rounds_per_unit = int(config["model"]["rounds"])

    def _model(self, rounds: int):
        from repro_torch.core import GossConfig, GradientBoostedTrees, TreeConfig
        mdl = self.cfg["model"]
        return GradientBoostedTrees(
            n_trees=rounds, learning_rate=mdl["learning_rate"],
            config=TreeConfig(**self.cfg["tree"]),
            goss=GossConfig(**mdl["goss"]), loss=mdl["loss"], seed=self.seed)

    def draw(self):
        """The bin codes and labels on the device, from the seed."""
        d = self.cfg["data"]
        with self.spans.span("make_data"):
            self.bins, self.y = make_binned(
                d["rows"], d["features"], d["codes"], depth=d["teacher_depth"],
                base_logit=d["teacher_base_logit"],
                logit_scale=d["teacher_logit_scale"], seed=self.seed,
                device=self.device)
            self.y_host = self.y.cpu().numpy()
        self.n_num = np.full(d["features"], d["codes"], np.int32)
        self.n_cat = np.zeros(d["features"], np.int32)
        self.n_bins = d["codes"] + 1                 # and the missing bin

    def setup(self):
        from repro_torch.core import BinnedTable
        self.draw()
        self.table = BinnedTable(bins=self.bins, n_num=self.n_num,
                                 n_cat=self.n_cat, metas=None,
                                 n_bins=self.n_bins)
        # one whole fit: every kernel built, the allocator at its steady
        # state for the fits that follow
        with self.spans.span("warmup"):
            self._fit()
        self.fits.clear()

    def _fit(self):
        # the previous fit is let go first, so that every fit finds the
        # memory the one before it freed; the last fit is the one checked
        self.kept = None
        with torch.profiler.record_function("portbench.fit"):
            with self.spans.span("fit"):
                model = self._model(self.rounds_per_unit).fit(
                    self.table, self.y_host, device=self.device)
        self.fits.append(tuple(t.n_nodes for t in model.trees))
        self.kept = (len(self.fits) - 1, model)

    def unit(self):
        self._fit()

    def profiled(self):
        self._fit()

    def end_to_end(self, window_s, units):
        return {"boost_round_ms": 1e3 * window_s / (units * self.rounds_per_unit)}

    def release(self):
        idx, model = self.kept
        self.kept = None
        self.kept_index = idx
        self.trees = [tree_numpy(t) for t in model.trees]
        n = min(int(self.cfg["check"]["raw_rows"]), self.bins.shape[0])
        self.raw_rows = torch.as_tensor(
            np.sort(self.rng.choice(self.bins.shape[0], n, replace=False)),
            device=self.device)
        self.raw_port = model.predict_raw_device(self.bins[self.raw_rows]).float()
        del model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, units):
        mdl, tc, lim = self.cfg["model"], self.cfg["tree"], self.cfg["limits"]
        r_all = len(self.trees)
        judged = sorted({0, r_all - 1, int(self.rng.integers(1, max(2, r_all - 1)))}
                        & set(range(r_all)))
        rules = ref_tree.Rules("moment", tc["max_depth"],
                               tc.get("min_samples_split", 2),
                               tc.get("min_samples_leaf", 1),
                               tc.get("min_child_weight", 0.0))
        n_num = torch.as_tensor(self.n_num)
        n_cat = torch.as_tensor(self.n_cat)
        res = dict(node_mismatch=0, rule_violations=0, label_gap=0.0,
                   gain_gap=0.0)
        self.rows_per_node = [None] * r_all

        def visit(r, rows, w, z):
            sample = self.bins[rows]
            if r in judged:
                j = ref_tree.judge(self.trees[r], sample,
                                   ref_boost.moment_stats(z, w, torch.float64),
                                   n_num, n_cat, self.n_bins, rules,
                                   tol=float(self.cfg["check"]["rule_margin"]))
                for k in ("node_mismatch", "rule_violations"):
                    res[k] += j[k]
                for k in ("label_gap", "gain_gap"):
                    res[k] = max(res[k], j[k])
                self.rows_per_node[r] = j["rows_per_node"]
            else:
                self.rows_per_node[r] = ref_tree.visits(
                    self.trees[r], sample, n_num, tc["max_depth"])

        raw_ref = ref_boost.replay(
            self.trees, self.bins, self.y, n_num, lr=mdl["learning_rate"],
            goss=ref_boost.Goss(**mdl["goss"]), seed=self.seed,
            steps=tc["max_depth"], visit=visit)
        ref = raw_ref[self.raw_rows].double()
        raw_gap = float(((self.raw_port.double() - ref).abs()
                         / (1.0 + ref.abs())).max())
        differing = sum(1 for s in self.fits if s != self.fits[self.kept_index])
        fit_s = self.spans.durations_within("fit", "window")
        self.counters.update(fits=units, fits_differing=differing,
                             fit_s=[round(x, 4) for x in fit_s],
                             judged_rounds=judged,
                             tree_nodes=[len(t["depth"]) for t in self.trees])
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
        """Counted work of one round, averaged over the fit's rounds."""
        d = self.cfg["data"]
        tot: dict = {}
        for tree, rows in zip(self.trees, self.rows_per_node):
            w = tree_work(tree, rows, n_features=d["features"],
                          n_bins=self.n_bins, channels=3, weighted=True)
            for k, v in w.items():
                tot[k] = tot.get(k, 0) + v
        r = len(self.trees)
        out = {k: v / r for k, v in tot.items()}
        out["table_bytes"] = boost_round_extra(d["rows"], self.cfg["tree"]["max_depth"])
        out["total_bytes"] = (out["hist_bytes"] + out["select_bytes"]
                              + out["route_bytes"] + out["table_bytes"])
        out["total_ops"] = out["hist_ops"] + out["select_ops"]
        return out
