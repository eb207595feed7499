"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (its look for a card skipped, at a small
size on the CPU).  The cells run on one card, so no exchange between
chips can be left out."""
import json

import pytest
import torch

import repro_torch.core as core
import repro_torch.core.forest as forest
import repro_torch.core.tree as tree_mod
from portbench.tests.test_portbench_run import run_small


def _unchanged_route(bins, assign, *a, **k):
    return assign                          # a level step that moves no row


def _half_rows_build(real):
    def build(table, y, *a, **k):
        import dataclasses
        half = table.bins.shape[0] // 2
        return real(dataclasses.replace(table, bins=table.bins[:half]),
                    y[:half], *a, **k)
    return build


def _altered_leaf_build(real):
    def build(*a, **k):
        t = real(*a, **k)
        leaf = torch.nonzero(t.leaf[:t.n_nodes])[-1, 0]
        t.label[leaf] = t.label[leaf] + 1.0
        return t
    return build


def _altered_grid_sweep(real):
    def sweep(*a, **k):
        res = real(*a, **k)
        res.metric[0, -1, 0] += 1.0
        return res
    return sweep


def _unchanged_scores(tree, bins, *a, **k):
    return torch.zeros(bins.shape[0], dtype=torch.float32, device=bins.device)


def _half_sample(real):
    def sample(*a, **k):
        idx, w = real(*a, **k)
        return idx[: len(idx) // 2], w[: len(w) // 2]
    return sample


FAULTS = {
    ("kdd99_10pct_udt.fit_tune", "state_unchanged"):
        lambda mp: mp.setattr(tree_mod, "_route_step", _unchanged_route),
    ("kdd99_10pct_udt.fit_tune", "half_batch"):
        lambda mp: mp.setattr(core, "build_tree", _half_rows_build(core.build_tree)),
    ("kdd99_10pct_udt.fit_tune", "answer_altered_tree"):
        lambda mp: mp.setattr(core, "build_tree", _altered_leaf_build(core.build_tree)),
    ("kdd99_10pct_udt.fit_tune", "answer_altered_grid"):
        lambda mp: mp.setattr(core, "sweep", _altered_grid_sweep(core.sweep)),
    ("higgs_gbt_goss.boost", "state_unchanged"):
        lambda mp: mp.setattr(forest, "predict_bins", _unchanged_scores),
    ("higgs_gbt_goss.boost", "half_batch"):
        lambda mp: mp.setattr(forest, "_goss_sample", _half_sample(forest._goss_sample)),
    ("higgs_gbt_goss.boost", "answer_altered"):
        lambda mp: mp.setattr(forest, "build_tree", _altered_leaf_build(forest.build_tree)),
}


@pytest.mark.parametrize("cell_name,fault", sorted(FAULTS))
def test_fault_comes_out_not_correct(cell_name, fault, monkeypatch):
    FAULTS[(cell_name, fault)](monkeypatch)
    code, out = run_small(cell_name)
    assert code == 0
    res = json.loads(out["stdout"])
    assert res["correct"] is False, out["stderr"]
