"""Checkpoints of the port (repro_torch.checkpoint) on the CPU: the npz +
manifest layout shared with repro.checkpoint, per-level tree-build resume
(equal to the uninterrupted tree, and cross-loading both ways with the
reference), and round checkpoints of boosted fits, whose resume is bit
for bit the uninterrupted fit, including after a SIGKILL."""
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.checkpoint import (RoundCheckpointer as JRoundCheckpointer,
                              TreeCheckpointer as JTreeCheckpointer,
                              restore_build_state as jrestore_build_state,
                              restore_pytree as jrestore_pytree,
                              save_pytree as jsave_pytree)
from repro.core import (GossConfig as JGoss, GradientBoostedTrees as JGBT,
                        TreeConfig as JConfig, build_tree as jbuild_tree,
                        fit_bins)
from repro.core.tree import _init_arrays as j_init_arrays
from repro.data import make_classification
from repro.resilience import corrupt_checkpoint
from repro_torch.checkpoint import (CheckpointCorruptError,
                                    CheckpointMismatchError, RoundCheckpoint,
                                    RoundCheckpointer, TreeCheckpointer,
                                    fit_digest, latest_step,
                                    restore_build_state, restore_pytree,
                                    restore_round_state, save_pytree)
from repro_torch.core import (GossConfig, GradientBoostedTrees, TreeConfig,
                              build_tree)
from repro_torch.core.binning import BinnedTable
from repro_torch.core.tree import TREE_FIELDS

CPU = "cpu"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def problem():
    cols, y = make_classification(1200, 6, 3, seed=3, n_cat_features=1)
    table = fit_bins(cols, max_num_bins=32)
    port = BinnedTable(bins=np.asarray(table.bins),
                       n_num=np.asarray(table.n_num),
                       n_cat=np.asarray(table.n_cat), metas=[],
                       n_bins=int(table.n_bins))
    return table, port, y


def _assert_same_tree(got, want, score_tol=0.0):
    n = want.n_nodes
    assert got.n_nodes == n
    for f in TREE_FIELDS:
        a, b = np.asarray(getattr(got, f))[:n], np.asarray(getattr(want, f))[:n]
        if f == "score" and score_tol:
            np.testing.assert_allclose(a, b, rtol=score_tol, atol=score_tol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _steps(directory):
    return sorted(int(fn.split("_")[1]) for fn in os.listdir(directory)
                  if fn.startswith("step_"))


# ------------------------------------------------------------- pytree layer

def test_pytree_round_trip(tmp_path):
    tree = {"b": {"y": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                  "x": np.array([True, False])},
            "a": torch.tensor([1.5, -2.0]), "skip": None}
    d = str(tmp_path)
    save_pytree(tree, d, 3, extra={"note": 1})
    save_pytree(tree, d, 12)
    os.makedirs(os.path.join(d, "step_00000099.tmp"))    # an unfinished write
    assert latest_step(d) == 12 and latest_step(str(tmp_path / "no")) is None
    out, manifest = restore_pytree({"a": 0, "b": {"x": 0, "y": 0}}, d, step=3)
    assert manifest["extra"] == {"note": 1}
    assert sorted(manifest["keys"]) == ["a", "b/x", "b/y"]
    assert manifest["keys"]["b/y"] == {"shape": [2, 3], "dtype": "int32"}
    np.testing.assert_array_equal(out["b"]["y"], tree["b"]["y"].numpy())
    np.testing.assert_array_equal(out["b"]["x"], tree["b"]["x"])
    assert out["a"].dtype == np.float32
    with pytest.raises(FileNotFoundError):
        restore_pytree({"a": 0}, str(tmp_path / "empty"))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_pytree_layout_reads_in_both_packages(tmp_path, writer):
    tree = {"arrays": {"feat": np.arange(5, dtype=np.int32),
                       "leaf": np.array([1, 0, 1, 0, 0], bool)},
            "assign": np.arange(7, dtype=np.int32)}
    d = str(tmp_path)
    (save_pytree if writer == "port" else jsave_pytree)(tree, d, 4,
                                                        extra={"depth": 4})
    template = {"arrays": {"feat": 0, "leaf": 0}, "assign": 0}
    for restore in (restore_pytree, jrestore_pytree):
        tmpl = template if restore is restore_pytree else {
            "arrays": {"feat": jnp.zeros(1), "leaf": jnp.zeros(1)},
            "assign": jnp.zeros(1)}
        out, manifest = restore(tmpl, d, 4)
        assert manifest["extra"] == {"depth": 4}
        np.testing.assert_array_equal(out["arrays"]["leaf"],
                                      tree["arrays"]["leaf"])
        np.testing.assert_array_equal(out["assign"], tree["assign"])


# ------------------------------------------------------ tree-build resume

@pytest.mark.parametrize("task,keep_phist", [("classification", True),
                                             ("classification", False),
                                             ("regression_variance", True)])
def test_build_resume_from_every_level_equals_uninterrupted(problem, tmp_path,
                                                           task, keep_phist):
    """Classification counts are exact either way; a float moment build is
    bit-identical when the parent cache comes back with it (the resumed
    level then takes the same subtraction path)."""
    _, port, y = problem
    cfg = TreeConfig(max_depth=5, task=task, chunk_slots=4)
    yy = y if task == "classification" else (y * 1.7 - 1).astype(np.float32)
    full = build_tree(port, yy, cfg, level_callback=TreeCheckpointer(
        str(tmp_path)), device=CPU)
    steps = _steps(str(tmp_path))
    assert steps == list(range(2, full.max_tree_depth + 2))
    with_phist = 0
    for step in steps:
        state = restore_build_state(str(tmp_path), step=step)
        with_phist += state.phist is not None
        if not keep_phist:
            state = state._replace(phist=None, phist_base=-1)
        _assert_same_tree(build_tree(port, yy, cfg, resume=state, device=CPU),
                          full)
    assert with_phist >= len(steps) - 1


def test_tree_checkpointer_every_levels(problem, tmp_path):
    _, port, y = problem
    build_tree(port, y, TreeConfig(max_depth=5),
               level_callback=TreeCheckpointer(str(tmp_path), every_levels=2),
               device=CPU)
    assert _steps(str(tmp_path)) == [3, 5]
    state = restore_build_state(str(tmp_path))
    assert state.depth == 5 and state.arrays["feat"].dtype == np.int32


def test_reference_tree_checkpoint_resumes_in_the_port(problem, tmp_path):
    table, port, y = problem
    jbuild_tree(table, y, JConfig(max_depth=5),
                level_callback=JTreeCheckpointer(str(tmp_path)))
    full = build_tree(port, y, TreeConfig(max_depth=5), device=CPU)
    for step in _steps(str(tmp_path)):
        state = restore_build_state(str(tmp_path), step=step)
        # the saved levels carry the reference's float scores
        _assert_same_tree(build_tree(port, y, TreeConfig(max_depth=5),
                                     resume=state, device=CPU),
                          full, score_tol=1e-5)


def test_port_tree_checkpoint_resumes_in_the_reference(problem, tmp_path):
    table, port, y = problem
    build_tree(port, y, TreeConfig(max_depth=5),
               level_callback=TreeCheckpointer(str(tmp_path)), device=CPU)
    full = jbuild_tree(table, y, JConfig(max_depth=5))
    m = len(y)
    tmpl = j_init_arrays(min(2 * m + 1, 1 << 22))
    for step in _steps(str(tmp_path)):
        state = jrestore_build_state(str(tmp_path), tmpl,
                                     jnp.zeros(m, jnp.int32), step=step)
        _assert_same_tree(jbuild_tree(table, y, JConfig(max_depth=5),
                                      resume=state), full, score_tol=1e-5)


def test_resume_rejects_a_checkpoint_of_another_size(problem, tmp_path):
    _, port, y = problem
    build_tree(port, y, TreeConfig(max_depth=3),
               level_callback=TreeCheckpointer(str(tmp_path)), device=CPU)
    state = restore_build_state(str(tmp_path))
    with pytest.raises(ValueError, match="max_nodes"):
        build_tree(port, y, TreeConfig(max_depth=3, max_nodes=100),
                   resume=state, device=CPU)


# ------------------------------------------------------ round checkpoints

class _Stop(Exception):
    pass


def _interrupted(est, table, y, directory, at_round, **kw):
    """Fit with a RoundCheckpointer and stop right after round ``at_round``
    is saved (a preemption between rounds)."""
    ck = RoundCheckpointer(directory, **kw)

    def callback(state):
        ck(state)
        if state.round == at_round:
            raise _Stop

    with pytest.raises(_Stop):
        est.fit(table, y, round_callback=callback, device=CPU)


def _gbt(loss, n_trees=5, seed=2, goss=(0.3, 0.2)):
    return GradientBoostedTrees(
        n_trees=n_trees, learning_rate=0.3,
        config=TreeConfig(max_depth=4, task="regression_variance"),
        loss=loss, goss=None if goss is None else GossConfig(*goss),
        seed=seed)


def _labels(loss, y):
    return (y == 1).astype(np.float32) if loss == "logistic" else (
        y if loss == "softmax" else (y * 0.5).astype(np.float32))


@pytest.mark.parametrize("loss,goss", [("logistic", (0.3, 0.2)),
                                       ("squared", None),
                                       ("softmax", (0.3, 0.2))])
def test_round_resume_is_bit_identical(problem, tmp_path, loss, goss):
    _, port, y = problem
    yy = _labels(loss, y)
    full = _gbt(loss, goss=goss).fit(port, yy, device=CPU)
    _interrupted(_gbt(loss, goss=goss), port, yy, str(tmp_path), 2)
    ck = restore_round_state(str(tmp_path))
    per_round = 3 if loss == "softmax" else 1
    assert ck.round == 2 and len(ck.trees) == 2 * per_round
    assert ck.raw.shape == ((3, len(y)) if loss == "softmax" else (len(y),))
    resumed = _gbt(loss, goss=goss).fit(port, yy, resume_from=str(tmp_path),
                                        device=CPU)
    assert len(resumed.trees) == len(full.trees) == 5 * per_round
    for a, b in zip(resumed.trees, full.trees):
        _assert_same_tree(a, b)
    np.testing.assert_array_equal(resumed.predict_raw(port.bins),
                                  full.predict_raw(port.bins))
    # a restored RoundCheckpoint object resumes the same way
    again = _gbt(loss, goss=goss).fit(port, yy, resume_from=ck, device=CPU)
    np.testing.assert_array_equal(again.predict_raw(port.bins),
                                  full.predict_raw(port.bins))


def test_round_checkpointer_every_and_keep_last(problem, tmp_path):
    _, port, y = problem
    yb = _labels("logistic", y)
    _gbt("logistic", n_trees=6).fit(
        port, yb, round_callback=RoundCheckpointer(str(tmp_path), every=2,
                                                   keep_last=2), device=CPU)
    assert _steps(str(tmp_path)) == [4, 6]
    keep_all = tmp_path / "all"
    _gbt("logistic", n_trees=3).fit(
        port, yb, round_callback=RoundCheckpointer(str(keep_all)),
        device=CPU)
    assert _steps(str(keep_all)) == [1, 2, 3]
    with pytest.raises(ValueError, match="every"):
        RoundCheckpointer(str(tmp_path), every=0)


@pytest.mark.parametrize("mode", ["truncate", "bitflip", "manifest"])
def test_corrupt_round_checkpoint_rejected(problem, tmp_path, mode):
    _, port, y = problem
    yb = _labels("logistic", y)
    _interrupted(_gbt("logistic"), port, yb, str(tmp_path), 2)
    corrupt_checkpoint(str(tmp_path), mode=mode, seed=1)
    with pytest.raises(CheckpointCorruptError):
        restore_round_state(str(tmp_path))
    with pytest.raises(CheckpointCorruptError):
        _gbt("logistic").fit(port, yb, resume_from=str(tmp_path), device=CPU)
    assert restore_round_state(str(tmp_path), step=1).round == 1


def test_digest_mismatch_rejected(problem, tmp_path):
    _, port, y = problem
    yb = _labels("logistic", y)
    _interrupted(_gbt("logistic"), port, yb, str(tmp_path), 2)
    for other in (_gbt("logistic", seed=3), _gbt("logistic", goss=(0.2, 0.2)),
                  _gbt("squared")):
        with pytest.raises(CheckpointMismatchError):
            other.fit(port, yb, resume_from=str(tmp_path), device=CPU)
    with pytest.raises(CheckpointMismatchError):
        _gbt("logistic").fit(port, yb[::-1].copy(),
                             resume_from=str(tmp_path), device=CPU)
    est = _gbt("logistic")
    assert fit_digest(est, port, yb, device=CPU) != fit_digest(
        est, port, yb, device="cuda")
    # digest=None is the caller's explicit escape hatch
    ck = restore_round_state(str(tmp_path))._replace(digest=None)
    _gbt("logistic", seed=3).fit(port, yb, resume_from=ck, device=CPU)
    assert isinstance(ck, RoundCheckpoint)


def test_reference_round_checkpoint_rejected(problem, tmp_path):
    """Round checkpoints do not cross-load: the reference's carries
    threefry key bits, which no torch generator state replaces."""
    table, port, y = problem
    yb = _labels("logistic", y)
    JGBT(n_trees=2, learning_rate=0.3,
         config=JConfig(max_depth=3, task="regression_variance"),
         loss="logistic", goss=JGoss(0.3, 0.2), seed=2).fit(
        table, yb, round_callback=JRoundCheckpointer(str(tmp_path)))
    assert restore_round_state(str(tmp_path)).round == 2
    with pytest.raises(CheckpointMismatchError):
        _gbt("logistic").fit(port, yb, resume_from=str(tmp_path), device=CPU)


_KILL_SCRIPT = r"""
import os, signal
import numpy as np
from repro_torch.checkpoint import RoundCheckpointer
from repro_torch.core import (GossConfig, GradientBoostedTrees, TreeConfig,
                              fit_bins)
from repro_torch.data import make_classification

cols, y = make_classification(500, 5, 3, seed=11)
table = fit_bins(cols, max_num_bins=32)
ck = RoundCheckpointer({ckdir!r})

def callback(state):
    ck(state)
    if state.round == 2:
        os.kill(os.getpid(), signal.SIGKILL)

GradientBoostedTrees(
    n_trees=4, learning_rate=0.3,
    config=TreeConfig(max_depth=3, task="regression_variance"),
    goss=GossConfig(0.3, 0.2), loss="softmax", seed=9).fit(
    table, y, round_callback=callback, device="cpu")
print("UNREACHABLE: survived the kill round")
"""


def test_sigkill_then_resume_is_bit_identical(tmp_path):
    from repro_torch.core import fit_bins as tfit_bins
    from repro_torch.data import make_classification as tmake
    ckdir = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _KILL_SCRIPT.format(ckdir=ckdir)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr)
    assert "UNREACHABLE" not in r.stdout
    assert _steps(ckdir) == [1, 2]
    cols, y = tmake(500, 5, 3, seed=11)
    table = tfit_bins(cols, max_num_bins=32)

    def est():
        return GradientBoostedTrees(
            n_trees=4, learning_rate=0.3,
            config=TreeConfig(max_depth=3, task="regression_variance"),
            goss=GossConfig(0.3, 0.2), loss="softmax", seed=9)

    full = est().fit(table, y, device=CPU)
    resumed = est().fit(table, y, resume_from=ckdir, device=CPU)
    for a, b in zip(resumed.trees, full.trees):
        _assert_same_tree(a, b)
    np.testing.assert_array_equal(resumed.predict_raw(table.bins),
                                  full.predict_raw(table.bins))
