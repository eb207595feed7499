"""The score walk's dispatch and wrapper on the CPU: a CPU tensor takes the
plain walk and launches nothing; on fake ``cuda`` tensors the wrapper makes
every argument check the card's launch makes and reports the launch it
would make; a boosting round's score update is one ``ops.walk``.  The
kernel itself is held against the plain walk in ``tests/test_torch_cuda.py``
(marker ``gpu``), the plain walk against the reference in
``tests/test_torch_predict.py`` and ``tests/test_torch_batched.py``."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.core import (GossConfig, GradientBoostedTrees,  # noqa: E402
                              TreeConfig, fit_bins)
from repro_torch.core.predict import stack_trees  # noqa: E402
from repro_torch.data import make_classification  # noqa: E402
from repro_torch.kernels import _checks, ops, ref  # noqa: E402
from repro_torch.kernels.walk import walk_cuda, walk_plain  # noqa: E402


def _fields(trees=2, slots=40, k=5):
    made = [ref.random_tree(t, k=k, n_bins=8, depth=6, slots=slots - t)
            for t in range(trees)]
    return (stack_trees([types.SimpleNamespace(**f) for f, _ in made]),
            max(n for _, n in made))


def test_cpu_tensors_take_the_plain_walk():
    fields, n = _fields()
    rng = np.random.default_rng(0)
    bins = torch.as_tensor(rng.integers(0, 11, (300, 5)), dtype=torch.int32)
    n_num = torch.full((5,), 8, dtype=torch.int32)
    ops.reset_launch_counts()
    got = ops.walk(fields, bins, n_num, num_steps=9, n_nodes=n, max_depth=5,
                   min_samples_split=3, min_child_weight=1.0)
    want = walk_plain(fields, bins, n_num, steps=4, min_samples_split=3,
                      min_child_weight=1.0)
    assert torch.equal(got, want) and got.shape == (2, 300)
    assert ops.launch_counts()["walk"] == 0


def _fake_operands(m=300, k=5, trees=2):
    """Fake ``cuda`` operands of a walk (no card needed).  A CPU-only build
    cannot view or copy a fake ``cuda`` tensor, so every layout is made
    with ``empty_strided``."""
    fields, n = _fields(trees, k=k)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        dev = torch.device("cuda")
        fake = {f: torch.empty(v.shape, dtype=v.dtype, device=dev)
                for f, v in fields.items()}
        bins = torch.empty((m, k), dtype=torch.int32, device=dev)
        n_num = torch.empty((k,), dtype=torch.int32, device=dev)
    return mode, fake, bins, n_num, n


def test_fake_cuda_walk_reports_one_launch(monkeypatch):
    heard = []
    monkeypatch.setattr(_checks, "listener",
                        lambda kernel, modes, smem: heard.append(
                            (kernel, modes, smem)))
    mode, fields, bins, n_num, n = _fake_operands()
    ops.reset_launch_counts()
    with mode:
        no_rows = torch.empty((0, 5), dtype=torch.int32, device=bins.device)
        per_tree = torch.empty((2, 5), dtype=torch.int32, device=bins.device)
        out = ops.walk(fields, bins, n_num, num_steps=6, n_nodes=n)
        empty = ops.walk(fields, no_rows, n_num, num_steps=6, n_nodes=n)
        masked = ops.walk(fields, bins, per_tree, num_steps=6)
    assert out.shape == masked.shape == (2, 300) and empty.shape == (2, 0)
    assert out.dtype == torch.float32 and out.device.type == "cuda"
    assert heard == [("walk", (), None)] * 2
    assert ops.launch_counts()["walk"] == 0


@pytest.mark.parametrize("case", ["bins_strided", "bins_int64", "bins_1d",
                                  "bins_on_cpu", "n_num_on_cpu",
                                  "n_num_shape", "fields_on_cpu",
                                  "field_dtype", "field_rows_apart",
                                  "n_nodes_past_the_slots", "n_nodes_zero"])
def test_fake_cuda_walk_refuses(case):
    mode, fields, bins, n_num, n = _fake_operands()
    kw = dict(steps=6, n_nodes=n)
    width = fields["feat"].shape[1]
    with mode:
        dev = bins.device
        if case == "bins_strided":
            bins = torch.empty_strided((300, 5), (1, 300), dtype=torch.int32,
                                       device=dev)
        elif case == "bins_int64":
            bins = torch.empty((300, 5), dtype=torch.int64, device=dev)
        elif case == "bins_1d":
            bins = torch.empty((300,), dtype=torch.int32, device=dev)
        elif case == "n_num_shape":
            n_num = torch.empty((4,), dtype=torch.int32, device=dev)
        elif case == "field_dtype":
            fields = dict(fields, count=torch.empty(
                (2, width), dtype=torch.int64, device=dev))
        elif case == "field_rows_apart":
            fields = dict(fields, label=torch.empty_strided(
                (2, width), (width + 9, 1), dtype=torch.float32, device=dev))
    if case == "n_nodes_past_the_slots":
        kw["n_nodes"] = width + 1
    elif case == "n_nodes_zero":
        kw["n_nodes"] = 0
    elif case == "bins_on_cpu":
        bins = torch.zeros((300, 5), dtype=torch.int32)
    elif case == "n_num_on_cpu":
        n_num = torch.zeros((5,), dtype=torch.int32)
    elif case == "fields_on_cpu":
        fields = dict(fields, tbin=torch.zeros((2, width), dtype=torch.int32))
    err = TypeError if case in ("bins_int64", "field_dtype") else ValueError
    with mode, pytest.raises(err):
        walk_cuda(fields, bins, n_num, **kw)


def test_ops_walk_hands_the_fields_over_in_one_layout(monkeypatch):
    """Fields of another dtype, or whose rows lie apart unequally, are laid
    out afresh; fields sharing one layout (a batched build's ``[C,
    max_nodes + 1]`` storage cut to ``max_nodes``) are handed over as they
    are."""
    seen = []
    real = ops.walk_plain
    monkeypatch.setattr(ops, "walk_plain", lambda fields, *a, **kw: (
        seen.append(fields), real(fields, *a, **kw))[1])
    fields, _ = _fields()
    shared = {f: torch.cat([v, v[:, :1]], dim=1)[:, :-1]
              for f, v in fields.items()}
    mixed = dict(shared, count=shared["count"].long(),
                 label=fields["label"].clone())
    columns = {f: v.t().contiguous().t() for f, v in fields.items()}
    bins = torch.zeros((10, 5), dtype=torch.int32)
    n_num = torch.full((5,), 8, dtype=torch.int32)
    out = [ops.walk(f, bins, n_num, num_steps=6)
           for f in (shared, mixed, columns)]
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
    assert all(v.stride() == (41, 1) for v in seen[0].values())
    assert all(v.is_contiguous() for s in seen[1:] for v in s.values())
    assert seen[1]["count"].dtype == torch.int32


@pytest.mark.parametrize("loss", ["logistic", "softmax"])
def test_a_round_updates_its_scores_in_one_walk(loss, monkeypatch):
    """An R-round GOSS logistic fit and an R-round softmax fit walk their
    scores through ``ops.walk`` once a round, one tree or C trees a call."""
    calls = []
    real = ops.walk

    def counted(fields, *a, **kw):
        calls.append(fields["feat"].shape[0])
        return real(fields, *a, **kw)

    monkeypatch.setattr(ops, "walk", counted)
    n_cls = 3 if loss == "softmax" else 2
    cols, y = make_classification(2000, 5, n_cls, seed=4, n_cat_features=1)
    table = fit_bins(cols, max_num_bins=16)
    labels = y.astype(np.int64 if loss == "softmax" else np.float32)
    GradientBoostedTrees(
        n_trees=3, learning_rate=0.3, loss=loss, seed=1,
        goss=GossConfig(0.2, 0.2),
        config=TreeConfig(max_depth=4, task="regression_variance")).fit(
            table, labels, device="cpu")
    assert calls == [n_cls if loss == "softmax" else 1] * 3
