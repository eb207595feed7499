"""The port's boundaries: it imports neither jax nor the JAX package, and
its entry points never fall back to the CPU on their own."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


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
    assert len(_modules()) >= 18


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
