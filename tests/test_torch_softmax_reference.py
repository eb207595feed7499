"""The port's multiclass softmax boosting against the benchmark's plain
reference (``portbench.reference.softmax``), on the CPU at small shapes.

Small twins of the KDD Cup 1999 10% table (4,000 rows, every class
present, the rarest floored at 8 rows) go through the benchmark cell's own
job (``portbench.jobs.softmax_boost``): the program's ``fit_bins``, then
``GradientBoostedTrees(loss="softmax").fit`` at the cell's tree rules over
fewer levels and bins.  Every class-tree of every round is held node by node to
the reference's replay of the fit (layout, stopping rules, the best split,
each node's Newton step), the validation raw scores to the reference's
float64 sum of the trees, and the cell's own check has to pass it and
refuse the reference grown in bfloat16.  The limits are the cell's."""
import pathlib
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from portbench import harness, trace  # noqa: E402
from portbench.jobs import softmax_boost  # noqa: E402
from portbench.reference import softmax as ref_softmax  # noqa: E402
from portbench.reference import tree as ref_tree  # noqa: E402
from portbench.reference.boost import moment_stats  # noqa: E402

CELL = "kdd99_10pct_softmax.boost"
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel workers, and torch's thread pool in each of them would
    oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _job(table_seed, chunk_slots=0, rounds=3):
    cell = harness.load_cell(CELL)
    cfg = harness.load_config(cell["config"])
    cfg["data"].update(rows=4000, table_seed=table_seed, max_num_bins=32)
    cfg["model"]["rounds"] = rounds
    cfg["tree"].update(max_depth=4, chunk_slots=chunk_slots)
    return softmax_boost.Job(config=cfg, cell=cell, seed=2**31 + 7 * table_seed,
                             device=CPU, spans=trace.Spans())


@pytest.fixture(scope="module", params=[(0, 0), (0, 2), (1, 0), (1, 2)],
                ids=lambda p: f"table{p[0]}-chunk{p[1] or 'auto'}")
def fitted(request):
    """A job's set-up and one whole fit, released for the check."""
    job = _job(*request.param)
    job.setup()
    job.unit()
    job.release()
    return job


def test_every_class_present_in_training(fitted):
    counts = np.bincount(fitted.y_tr, minlength=fitted.n_classes)
    assert counts.min() >= 1 and counts.sum() == len(fitted.y_tr)


def test_every_class_tree_node_by_node(fitted):
    job = fitted
    tc, lim = job.cfg["tree"], job.cfg["limits"]
    n_cls = job.n_classes
    rules = ref_tree.Rules("moment", tc["max_depth"], tc["min_samples_split"],
                           tc["min_samples_leaf"], tc["min_child_weight"])
    n_num, n_cat = torch.as_tensor(job.n_num), torch.as_tensor(job.n_cat)
    worst = dict(node_mismatch=0, rule_violations=0, label_gap=0.0,
                 gain_gap=0.0)
    judged = []

    def visit(r, z, h):
        for c in range(n_cls):
            tree = job.trees[r * n_cls + c]
            j = ref_tree.judge(tree, job.bins_tr,
                               moment_stats(z[c], h[c], torch.float64), n_num,
                               n_cat, job.n_bins, rules,
                               tol=job.cfg["check"]["rule_margin"])
            worst["node_mismatch"] += j["node_mismatch"]
            worst["rule_violations"] += j["rule_violations"]
            worst["gain_gap"] = max(worst["gain_gap"], j["gain_gap"])
            worst["label_gap"] = max(worst["label_gap"], ref_softmax.label_gap(
                tree, job.bins_tr, n_num, z[c], h[c], tc["max_depth"]))
            judged.append(len(tree["depth"]))

    y = torch.as_tensor(job.y_tr).long()
    ref_softmax.replay(job.trees, job.bins_tr, y, n_num, n_classes=n_cls,
                       lr=job.cfg["model"]["learning_rate"],
                       steps=tc["max_depth"], visit=visit)
    assert len(judged) == len(job.trees) == 3 * n_cls
    assert max(judged) > 1                      # some class-tree splits
    assert worst["node_mismatch"] == 0 and worst["rule_violations"] == 0
    assert worst["label_gap"] <= lim["label_gap"]
    assert worst["gain_gap"] <= lim["gain_gap"]


def test_raw_scores_and_the_cells_check(fitted):
    job = fitted
    checks, failed = job.check(1)
    assert failed == 0, checks
    assert all(v <= limit for v, limit in checks.values()), checks
    assert checks["raw_gap"][0] <= job.cfg["limits"]["raw_gap"]
    assert job.raw_port.shape == (len(job.va), job.n_classes)


@pytest.mark.parametrize("table_seed", [0, 1])
@pytest.mark.parametrize("dtype,correct", [("bfloat16", False),
                                           ("float64", True)])
def test_control_refused_below_float32(table_seed, dtype, correct):
    """The reference in the program's place passes the cell's check in
    float64 and is refused by it in bfloat16."""
    job = _job(table_seed)
    softmax_boost.control(job, getattr(torch, dtype))
    checks, failed = job.check(1)
    passed = failed == 0 and all(v <= limit for v, limit in checks.values())
    assert passed is correct, checks
