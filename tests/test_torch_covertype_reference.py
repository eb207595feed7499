"""The port's fit-and-tune job on the Covertype twin against the
benchmark's plain references, on the CPU at small shapes.

A small twin of UCI Covertype (1,200 rows, all 54 columns and 7 classes)
goes through the benchmark cell's own job
(``portbench.jobs.covertype_fit_tune``) at few bins, with chunks of 8
slots and a subtraction cache of 12 slots, so that wide levels run in
several chunks and lose the cache; the cell's check must pass it (the
tree node by node against the blocked judge, the sweep against
``grid_correct``) and refuse the reference grown in bfloat16.  The blocked
judge must equal ``reference/tree.py::judge`` at every block size, on the
port's tree and on trees with faults.  The twin keeps its schema, its
class counts and its draw; the level loop's ``levels_uncached`` counts
the levels its host widths say."""
import hashlib
import pathlib
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from portbench import control, harness, trace  # noqa: E402
from portbench.data import covertype  # noqa: E402
from portbench.jobs import covertype_fit_tune  # noqa: E402
from portbench.reference import tree as ref_tree  # noqa: E402
from portbench.reference import wide_tree  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.core import TreeConfig, build_tree  # noqa: E402

CELL = "covertype_udt.fit_tune"
CPU = torch.device("cpu")
ROWS, BINS, CHUNK, CACHE = 1200, 8, 8, 12
# sha256 of a 2,000-row draw of the twin (columns, then labels)
DIGEST = "88d60e7a5292907bcd0a79fcbc3dcb1ba0ac811e1d196da9d8b7fa7df1e769cb"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel workers, and torch's thread pool in each of them would
    oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row_bytes():
    return covertype.N_FEATURES * (BINS + 1) * len(covertype.CLASS_NAMES) * 4


def _job(**tree):
    cell = harness.load_cell(CELL)
    cfg = harness.load_config(cell["config"])
    cfg["data"].update(rows=ROWS, max_num_bins=BINS)
    cfg["tree"].update(chunk_slots=CHUNK, sub_cache_bytes=CACHE * _row_bytes(),
                       **tree)
    return covertype_fit_tune.Job(config=cfg, cell=cell, seed=2**31 + 33,
                                  device=CPU, spans=trace.Spans())


@pytest.fixture(scope="module")
def job():
    """A job's set-up and one whole job, released for the check."""
    job = _job()
    job.setup()
    job.unit()
    job.release()
    return job


def _widths(tree):
    return np.bincount(np.asarray(tree["depth"]))[1:]


def test_the_job_chunks_and_loses_the_cache_and_passes_the_check(job):
    widths = _widths(job.kept_tree)
    assert widths.max() > 2 * CHUNK and (widths > CACHE).any()
    assert int(job.table.n_bins) == BINS + 1
    checks, failed = job.check(1)
    assert failed == 0, checks
    for name in ("bins_mismatch", "node_mismatch", "rule_violations",
                 "toot_mismatch", "jobs_differing"):
        assert checks[name][0] == 0, (name, checks)
    assert checks["gain_gap"][0] <= checks["gain_gap"][1]
    c = job.counters
    assert c["tree_nodes"] == len(job.kept_tree["depth"])
    assert (c["tree_depth"], c["tree_widest"]) == (len(widths), widths.max())
    assert 0.488 < c["best_accuracy"] < 1.0
    assert c["rows_scattered"] >= len(job.y_tr)


def _faulty(tree, fault):
    t = {k: np.array(v) for k, v in tree.items()}
    inner = np.nonzero(~t["leaf"])[0]
    leaves = np.nonzero(t["leaf"])[0]
    if fault == "label":
        t["label"][leaves[len(leaves) // 2]] += 1
    elif fault == "split":
        t["tbin"][0] = (t["tbin"][0] + 3) % BINS
    elif fault == "stopped":
        u = inner[-1]
        t["leaf"][u], t["left"][u], t["right"][u] = True, -1, -1
    return t


@pytest.fixture(scope="module")
def whole_level(job):
    """``reference/tree.py::judge``'s reading of each faulty tree, with
    the judges' shared arguments."""
    tc = job.cfg["tree"]
    rules = ref_tree.Rules("class", tc["max_depth"], tc["min_samples_split"],
                           tc["min_samples_leaf"])
    args = (torch.as_tensor(job.table.bins[job.tr]),
            torch.nn.functional.one_hot(torch.as_tensor(job.y_tr).long(),
                                        job.n_classes).double(),
            torch.as_tensor(job.table.n_num), torch.as_tensor(job.table.n_cat),
            int(job.table.n_bins), rules)
    read = {}

    def judged(fault):
        if fault not in read:
            tree = _faulty(job.kept_tree, fault)
            read[fault] = tree, ref_tree.judge(tree, *args)
        return read[fault]
    return judged, args


@pytest.mark.parametrize("block,fault", [
    (1, "none"), (7, "none"), (None, "none"),
    (7, "label"), (7, "split"), (7, "stopped")])
def test_blocked_judge_equals_the_whole_level_judge(whole_level, block,
                                                    fault):
    """At blocks of 1 and 7 nodes and of a whole level, on the port's tree
    and on trees with a fault each judge has to find."""
    judged, args = whole_level
    tree, want = judged(fault)
    got = wide_tree.judge(tree, *args,
                          block=block or int(_widths(tree).max()))
    assert np.array_equal(got["rows_per_node"], want["rows_per_node"])
    assert got.keys() == want.keys()
    for k in ("node_mismatch", "gain_gap", "rule_violations"):
        assert got[k] == want[k], k
    assert (fault == "none") == (want["node_mismatch"] + want["rule_violations"]
                                 == 0 and want["gain_gap"] <= 1e-3)


def test_blocked_judge_refuses_a_moment_tree(job):
    rules = ref_tree.Rules("moment", 4)
    with pytest.raises(ValueError, match="class trees"):
        wide_tree.judge(job.kept_tree, None, None, None, None, 9, rules)


def test_block_nodes_holds_the_budget():
    # a Covertype node's float64 [54, 257, 7] histogram is 777,168 B
    per = wide_tree.COPIES * 777_168
    assert wide_tree.block_nodes(54, 257, 7) == (8 << 30) // per
    assert wide_tree.block_nodes(54, 257, 7, budget_bytes=1) == 1


@pytest.mark.parametrize("dtype,correct", [("bfloat16", False),
                                           ("float64", True)])
def test_control_refused_below_float32(dtype, correct):
    """The reference in the program's place passes the cell's check in
    float64 and is refused by it in bfloat16."""
    job = _job()
    control.control_fit_tune(job, getattr(torch, dtype))
    checks, failed = job.check(1)
    passed = failed == 0 and all(v <= limit for v, limit in checks.values())
    assert passed is correct, checks


def test_twin_schema_and_ranges():
    m = 20_000
    cols, y = covertype.synth_covertype(m, 2**31 + 1)
    assert len(cols) == covertype.N_FEATURES == 54
    assert all(c.dtype == np.float32 and c.shape == (m,) for c in cols)
    for (name, lo, hi, _, _), c in zip(covertype.NUMERIC, cols):
        assert lo <= c.min() and c.max() <= hi, name
        assert np.array_equal(c, np.rint(c)), name
    onehot = np.stack(cols[10:], 1)
    assert set(np.unique(onehot)) == {0.0, 1.0}
    assert (onehot[:, :4].sum(1) == 1).all() and (onehot[:, 4:].sum(1) == 1).all()
    assert np.array_equal(np.bincount(y, minlength=7),
                          covertype.class_counts(m))
    assert tuple(covertype.class_counts(covertype.N_ROWS)) \
        == covertype.CLASS_COUNTS
    assert covertype.class_counts(m).sum() == m


def test_twin_draw_is_frozen():
    cols, y = covertype.synth_covertype(2000, 2**31 + 5)
    h = hashlib.sha256(np.stack(cols).tobytes() + y.tobytes()).hexdigest()
    assert h == DIGEST
    again, y2 = covertype.synth_covertype(2000, 2**31 + 5)
    assert np.array_equal(np.stack(again), np.stack(cols))
    assert np.array_equal(y, y2)



def _build_counted(job, monkeypatch, **kw):
    """A build with the program's counters on: the flag they read, set as
    a recording profiler sets it (``test_torch_tracing.py`` runs them under
    the profiler itself)."""
    cfg = TreeConfig(**{**job.cfg["tree"], **kw})
    tracing.reset()
    with monkeypatch.context() as m:
        m.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
        tree = build_tree(job.train, job.y_tr, cfg, n_classes=job.n_classes,
                          device="cpu")
    c = tracing.counters()
    tracing.reset()
    return tree, c


def test_levels_uncached_counts_the_wide_levels(job, monkeypatch):
    """A level counts when it is above ``max_depth``, has children to cache
    for and is wider than the cache holds, from the host's widths."""
    tree, c = _build_counted(job, monkeypatch, max_depth=9)
    widths = np.bincount(tree.depth[:tree.n_nodes].numpy())[1:]
    want = sum(1 for d, w in enumerate(widths, 1) if d < 9 and w > CACHE)
    assert want >= 1
    assert c["levels_uncached"] == {"tree.level": want}


def test_levels_uncached_is_zero_on_a_narrow_build(job, monkeypatch):
    _, c = _build_counted(job, monkeypatch, chunk_slots=0,
                          sub_cache_bytes=1 << 28, max_depth=6)
    assert c["levels_uncached"] == {}
    assert c["stack_slots"]
