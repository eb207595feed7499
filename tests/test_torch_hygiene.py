"""The port's boundaries: it imports neither jax nor the JAX package, its
entry points never fall back to the CPU on their own, and its tests collect
(as skips) where the optional torch extra is missing."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"
TESTS = SRC.parent / "tests"

# a sitecustomize that makes torch unimportable, as on an install without
# the torch extra
NO_TORCH = """
import sys

class _NoTorch:
    def find_spec(self, name, path=None, target=None):
        if name == "torch" or name.startswith("torch."):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None

sys.meta_path.insert(0, _NoTorch())
"""


def _modules():
    return sorted(".".join(p.relative_to(SRC).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'"
            " or m.startswith(('jax.', 'repro.')))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"
    assert len(_modules()) >= 67


def test_check_package_records_without_jax_or_repro():
    """The contract gate (``repro_torch.check``) is part of the port:
    recording every contract on the CPU loads no jax and nothing of the
    JAX package."""
    assert {"repro_torch.check", "repro_torch.check.recorder",
            "repro_torch.check.contracts"} <= set(_modules())
    code = ("import sys\n"
            "from repro_torch.check.cli import main\n"
            "rc = main(['--device', 'cpu'])\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'"
            " or m.startswith(('jax.', 'repro.')))\n"
            "print(rc, bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "0 []"


def test_no_jax_or_repro_import_lines():
    for p in [*PKG.rglob("*.py"), SRC.parent / "chip_smoke.py"]:
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import repro ",
                                     "from repro.", "from repro ")), (p, line)
            assert s != "import repro", (p, line)


def _cuda_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.core import TreeConfig, build_tree, fit_bins, paths, predict_bins
    from repro_torch.core.tree import tree_from_numpy, TREE_FIELDS
    from repro_torch.kernels import ops
    _cuda_only(monkeypatch)
    table = fit_bins([[1.0, 2.0, 3.0, 4.0]])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_tree(table, np.array([0, 0, 1, 1]), TreeConfig())
    tree = build_tree(table, np.array([0, 0, 1, 1]), TreeConfig(), device="cpu")
    carried = tree_from_numpy({f: getattr(tree, f).numpy() for f in TREE_FIELDS},
                              tree.n_nodes)
    for fn in (predict_bins, paths):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(carried, table.bins, table.n_num)
    bins = np.zeros((4, 1), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.histogram(bins, np.ones((4, 2), np.float32), np.zeros(4, np.int32),
                      num_slots=1, n_bins=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.split_scan(np.ones((1, 1, 5, 2), np.float32),
                       np.array([4], np.int32), np.array([0], np.int32))


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.histogram import histogram_cuda
    from repro_torch.kernels.split_scan import split_scan_cuda
    with pytest.raises(ValueError, match="CUDA tensors"):
        histogram_cuda(torch.zeros((4, 1), dtype=torch.int32),
                       torch.ones((4, 2)), torch.zeros(4, dtype=torch.int32),
                       num_slots=1, n_bins=5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        split_scan_cuda(torch.ones((1, 1, 5, 2)),
                        torch.tensor([4], dtype=torch.int32),
                        torch.tensor([0], dtype=torch.int32))


def test_cpu_tensors_take_the_plain_versions():
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    h = ops.histogram(torch.zeros((4, 1), dtype=torch.int32), torch.ones((4, 2)),
                      torch.zeros(4, dtype=torch.int32), num_slots=1, n_bins=5)
    assert h.device.type == "cpu" and float(h[0, 0, 0, 0]) == 4.0
    assert set(ops.launch_counts().values()) == {0}


def test_tuning_and_boosting_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.core import (GradientBoostedTrees, TreeConfig,
                                  build_tree, ensemble_from_numpy, fit_bins,
                                  path_tables, sweep)
    from repro_torch.core.generic import generic_best_split_on_feature
    _cuda_only(monkeypatch)
    table = fit_bins([[1.0, 2.0, 3.0, 4.0]])
    y = np.array([0, 0, 1, 1])
    tree = build_tree(table, y, TreeConfig(), device="cpu")
    for call in (
            lambda: sweep(tree, table.bins, y, table.n_num),
            lambda: path_tables(tree, table.bins, table.n_num),
            lambda: GradientBoostedTrees(n_trees=1).fit(table, y * 1.0),
            lambda: generic_best_split_on_feature(
                table.bins[:, 0], y, 4, 0, n_classes=2, n_bins=5),
            lambda: ensemble_from_numpy([], base=0.0, learning_rate=0.1,
                                        loss="squared", n_num=table.n_num)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    ens = GradientBoostedTrees(n_trees=1).fit(table, y * 1.0, device="cpu")
    assert ens.predict(table.bins).shape == (4,)


def test_ensembles_and_batched_build_raise_without_a_card(monkeypatch):
    from repro_torch.core import (GradientBoostedTrees, RandomForest,
                                  TreeConfig, build_trees_batched, fit_bins,
                                  walk_class_trees)
    from repro_torch.kernels import ops
    from repro_torch.kernels.histogram import histogram_stacked_cuda
    _cuda_only(monkeypatch)
    table = fit_bins([[1.0, 2.0, 3.0, 4.0]])
    y = np.array([0, 1, 2, 1])
    z = np.ones((3, 4), np.float32)
    cfg = TreeConfig(task="regression_variance")
    for call in (
            lambda: RandomForest(n_trees=1).fit(table, y),
            lambda: GradientBoostedTrees(n_trees=1, loss="softmax").fit(
                table, y),
            lambda: build_trees_batched(table, z, cfg),
            lambda: ops.histogram_stacked(
                np.zeros((4, 1), np.int32), np.ones((2, 4, 2), np.float32),
                np.zeros((2, 4), np.int32), num_slots=1, n_bins=5)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    _, arrays = build_trees_batched(table, z, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        walk_class_trees({f: v.numpy() for f, v in arrays.items()},
                         table.bins, table.n_num, num_steps=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        histogram_stacked_cuda(torch.zeros((4, 1), dtype=torch.int32),
                               torch.ones((2, 4, 2)),
                               torch.zeros((2, 4), dtype=torch.int32),
                               num_slots=1, n_bins=5)
    assert RandomForest(n_trees=2).fit(table, y, device="cpu").predict(
        table.bins).shape == (4,)
    ens = GradientBoostedTrees(n_trees=1, loss="softmax").fit(table, y,
                                                              device="cpu")
    assert ens.predict_raw(table.bins).shape == (4, 3)


def test_mesh_entry_points_raise_without_a_card(monkeypatch):
    """The mesh fits and the mesh sweep resolve their device first: without
    a card and without ``device="cpu"`` they raise before any collective."""
    from repro_torch.core import (GradientBoostedTrees, RandomForest,
                                  TreeConfig, build_tree, fit_bins, sweep)
    _cuda_only(monkeypatch)
    table = fit_bins([[1.0, 2.0, 3.0, 4.0]])
    y = np.array([0, 0, 1, 1])
    tree = build_tree(table, y, TreeConfig(), device="cpu")
    mesh = object()
    for call in (
            lambda: GradientBoostedTrees(n_trees=1).fit(table, y * 1.0,
                                                        mesh=mesh),
            lambda: RandomForest(n_trees=1).fit(table, y, mesh=mesh),
            lambda: sweep(tree, table.bins, y, table.n_num, mesh=mesh)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    """The LM serving path resolves its device first: ``init_params``,
    ``params_from_numpy``, ``generate`` and the launcher raise without a
    card unless the caller asks for the CPU."""
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model as M
    from repro_torch.serve import generate
    _cuda_only(monkeypatch)
    cfg = configs.get_smoke("smollm_360m")
    model = M.init_params(cfg, device="cpu")
    prompt = torch.zeros((1, 2), dtype=torch.int32)
    tree = {"embed": np.zeros((cfg.vocab, cfg.d_model), np.float32),
            "final_norm": np.zeros((cfg.d_model,), np.float32),
            "groups": [], "remainder": []}
    for call in (
            lambda: M.init_params(cfg),
            lambda: M.params_from_numpy(tree, cfg),
            lambda: generate(model, prompt, 2, max_len=4),
            lambda: launch_serve.main(["--smoke"]),
            lambda: launch_serve.main(["--forest", "--tenants", "1",
                                       "--requests", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert generate(model, prompt, 2, max_len=4, device="cpu").shape == (1, 2)


def test_rank_scripts_import_no_jax_and_no_repro():
    """The gloo worlds' rank scripts run the port alone: the reference's
    oracles stay in the test process or its own subprocess."""
    sys.path.insert(0, str(TESTS))
    try:
        import _dist_worlds
    finally:
        sys.path.remove(str(TESTS))
    for script in (_dist_worlds.RANK_SCRIPT, _dist_worlds.FIT_SCRIPT):
        for line in script.splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "from repro.",
                                     "from repro ", "import repro ")), line
            assert s != "import repro", line
        assert "repro_torch" in script


def test_tests_collect_without_torch(tmp_path):
    """Every port test module skips at collection without torch, and the
    JAX package's tests beside them still collect: no collection error."""
    (tmp_path / "sitecustomize.py").write_text(NO_TORCH)
    port = sorted(TESTS.glob("test_torch_*.py"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path),
                                                       str(SRC)]),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only",
         "-p", "no:cacheprovider", *map(str, port),
         str(TESTS / "test_tree.py")],
        cwd=SRC.parent, env=env, capture_output=True, text=True, timeout=300)
    tail = out.stdout[-3000:] + out.stderr[-2000:]
    assert out.returncode == 0, tail
    assert "error" not in out.stdout.lower(), tail
    assert f"{len(port)} skipped" in out.stdout, tail
    assert "<Function test_tree_invariants>" in out.stdout, tail
