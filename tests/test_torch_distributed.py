"""The port's sharded build (repro_torch.core.distributed) on gloo worlds of
CPU processes, held against the port's local build.

The worlds are the reference's own cases (``tests/test_distributed.py``'s
SCRIPT: the same data, ``max_depth=10``, ``chunk_slots=64`` and the six
DistConfig variants) on meshes of 2x2 ("data", "model"), 4x1 (data only),
1x4 (model only) and 2x2x2 ("pod", "data", "model"), each world N
processes over a file store with its own deadline (``_dist_worlds``).
Two cases have a row count no data-shard count above 1 divides (601
classification rows on every world, 501 label-split rows on 2x2), so
their padding rows must reach no tree.

Classification trees equal the local ``build_tree`` field for field, split
score included: integer class counts are exact in any reduction order.  The
float moment tasks are held to the reference's tolerance (prediction RMSE
under 5 % of the target's spread, node counts within 5 % + 8).  The class
axis of ``build_batched`` is exact on integer-valued targets and weights
and within rtol/atol 1e-4 of the local prediction on float ones.  On one
rank (an in-process gloo group, 1x1 mesh) the port's sharded build equals
the reference's ``build_tree_distributed`` on a 1x1 ``jax.sharding.Mesh``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.core import (TreeConfig as JConfig, fit_bins)  # noqa: E402
from repro.core.distributed import (  # noqa: E402
    DistConfig as JDist, build_tree_distributed as jbuild_dist)
from repro.data import make_classification, make_regression  # noqa: E402
from repro_torch.core import (TreeConfig, build_tree,  # noqa: E402
                              build_trees_batched, predict_bins)
from repro_torch.core.binning import BinnedTable  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DistConfig, DistributedBuilder, build_tree_distributed, scatter_ok)
from repro_torch.core.split import OP_GT, OP_LE  # noqa: E402
from repro_torch.core.tree import TREE_FIELDS, tree_from_numpy  # noqa: E402

from _dist_worlds import run_world  # noqa: E402

BASE = dict(max_depth=10, chunk_slots=64)
KERNELS = dict(hist_backend="kernel", select_backend="kernel")


def _configs(data_axes):
    """The reference SCRIPT's six classification variants."""
    d, m = list(data_axes), "model"
    return {
        # slot scatter + sibling subtraction composed (both on by default)
        "composed": (dict(data_axes=d, model_axis=m), {}),
        "data_only": (dict(data_axes=d, model_axis=None), {}),
        "model_only": (dict(data_axes=[], model_axis=m), {}),
        # subtraction with a psum of the packed smaller-child block
        "psum_sub": (dict(data_axes=d, model_axis=m, slot_scatter=False), {}),
        # pair counts that do not divide 4 data shards: fallback chunks
        "mixed_chunks": (dict(data_axes=d, model_axis=m),
                         dict(chunk_slots=20)),
        # no scatter, no subtraction
        "dense": (dict(data_axes=d, model_axis=m, slot_scatter=False),
                  dict(sibling_subtraction=False)),
    }


CLS = tuple(_configs(("data",)))


def _cls_cases(data_axes):
    # "padded": 601 rows, which no data-shard count above 1 divides, so
    # every rank pads its block; the padding rows' one-hot statistics
    # (made from their staged labels) must reach no tree
    return [dict(name=n, problem="cls", y="cls/y", n_classes=3, dist=dist,
                 cfg=dict(BASE, task="classification", **cfg))
            for n, (dist, cfg) in _configs(data_axes).items()] + [
        dict(name="padded", problem="cls601", y="cls601/y", n_classes=3,
             dist=dict(data_axes=list(data_axes), model_axis="model"),
             cfg=dict(BASE, task="classification"))]


_D2 = dict(data_axes=["data"], model_axis="model")
WORLDS = {
    "2x2": ((2, 2), ("data", "model"), _cls_cases(("data",)) + [
        dict(name="regression", problem="reg", y="reg/y", dist=_D2,
             cfg=dict(BASE, task="regression")),
        dict(name="regression_variance", problem="reg", y="reg/y", dist=_D2,
             cfg=dict(BASE, task="regression_variance")),
        # label-split regression on 501 rows (padded on 2 data shards) with
        # integer-valued targets, whose label sums are exact in any order
        dict(name="regression_padded", problem="reg501", y="reg501/y",
             dist=_D2, cfg=dict(BASE, task="regression")),
        dict(name="weighted", problem="cls", y="cls/y", n_classes=3,
             weights="cls/w", dist=_D2, cfg=dict(BASE, task="classification")),
        dict(name="kernels_data_only", problem="cls", y="cls/y", n_classes=3,
             dist=dict(data_axes=["data"], model_axis=None),
             cfg=dict(BASE, task="classification", **KERNELS)),
        dict(name="batched_int", problem="cls", y="cls/z_int",
             weights="cls/h_int", batched=True, dist=_D2,
             cfg=dict(max_depth=5, chunk_slots=16,
                      task="regression_variance")),
        dict(name="batched_float", problem="cls", y="cls/z",
             weights="cls/h", batched=True, dist=_D2,
             cfg=dict(max_depth=5, chunk_slots=16,
                      task="regression_variance")),
    ]),
    "4x1": ((4, 1), ("data", "model"), _cls_cases(("data",))),
    "1x4": ((1, 4), ("data", "model"), _cls_cases(("data",)) + [
        dict(name=f"tie_{sel}", problem="tie", y="tie/y", n_classes=2,
             dist=dict(data_axes=["data"], model_axis="model"),
             cfg=dict(max_depth=2, task="classification",
                      select_backend=sel))
        for sel in ("torch", "kernel")]),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"),
              _cls_cases(("pod", "data"))),
}


def _port(table):
    return BinnedTable(bins=np.asarray(table.bins),
                       n_num=np.asarray(table.n_num),
                       n_cat=np.asarray(table.n_cat), metas=[],
                       n_bins=int(table.n_bins))


def _tie_table():
    """A GT on feature 0 and an LE on feature 1 with the same partition
    (so the same score), features 2 and 3 constant.  Bin 2 is missing (>=
    n_num), so feature 0's LE and GT differ."""
    a, b_lo, b_miss = 40, 20, 20
    m = a + b_lo + b_miss
    bins = np.zeros((m, 4), np.int32)
    bins[:a, 0], bins[a:a + b_lo, 0], bins[a + b_lo:, 0] = 1, 0, 2
    bins[:a, 1], bins[a:, 1] = 0, 1
    y = np.r_[np.ones(a), np.zeros(b_lo + b_miss)].astype(np.int64)
    table = BinnedTable(bins=bins, n_num=np.full(4, 2, np.int32),
                        n_cat=np.zeros(4, np.int32), metas=[], n_bins=3)
    return table, y


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    cols, y = make_classification(600, 7, 3, seed=9, n_cat_features=2,
                                  missing_frac=0.02)
    cls = _port(fit_bins(cols, max_num_bins=32))
    colsr, yr = make_regression(500, 5, seed=4)
    reg = _port(fit_bins(colsr, max_num_bins=32))
    tie, ytie = _tie_table()
    cols6, y6 = make_classification(601, 7, 3, seed=9, n_cat_features=2,
                                    missing_frac=0.02)
    colsr5, yr5 = make_regression(501, 5, seed=4)
    rng = np.random.default_rng(0)
    m = len(y)
    extra = {"cls/w": rng.integers(1, 4, m).astype(np.float32),
             "cls/z_int": rng.integers(-3, 4, (3, m)).astype(np.float32),
             "cls/h_int": rng.integers(1, 3, (3, m)).astype(np.float32),
             "cls/z": rng.normal(size=(3, m)).astype(np.float32),
             "cls/h": rng.uniform(0.05, 0.25, (3, m)).astype(np.float32)}
    out = dict(tables={"cls": cls, "reg": reg, "tie": tie,
                       "cls601": _port(fit_bins(cols6, max_num_bins=32)),
                       "reg501": _port(fit_bins(colsr5, max_num_bins=32))},
               arrays={"cls/y": np.asarray(y), "reg/y": np.asarray(yr),
                       "tie/y": ytie, "cls601/y": np.asarray(y6),
                       "reg501/y": np.round(4 * yr5 / yr5.std()).astype(
                           np.float32), **extra})
    flat = {}
    for p, t in out["tables"].items():
        flat.update({f"{p}/bins": t.bins, f"{p}/n_num": t.n_num,
                     f"{p}/n_cat": t.n_cat, f"{p}/n_bins": t.n_bins})
    path = tmp_path_factory.mktemp("dist_data") / "problems.npz"
    np.savez(path, **flat, **out["arrays"])
    out["path"] = path
    return out


@pytest.fixture(scope="module")
def world(problems, tmp_path_factory):
    """``world(name)`` runs that world once (failures are kept too) and
    returns (trees, collective counts by rank, cases)."""
    done = {}

    def get(name):
        if name not in done:
            shape, names, cases = WORLDS[name]
            try:
                done[name] = run_world(tmp_path_factory.mktemp(name), shape,
                                       names, cases, problems["path"])
            except AssertionError as e:
                done[name] = e
        if isinstance(done[name], AssertionError):
            raise done[name]
        trees, counts = done[name]
        return trees, counts, {c["name"]: c for c in WORLDS[name][2]}
    return get


def _local(problems, case):
    table = problems["tables"][case["problem"]]
    return build_tree(table, problems["arrays"][case["y"]],
                      TreeConfig(**case["cfg"]),
                      n_classes=case.get("n_classes"),
                      sample_weight=problems["arrays"].get(case.get("weights")),
                      device="cpu")


def _assert_same(got: dict, want):
    n = want.n_nodes
    assert int(got["n_nodes"]) == n
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(got[f], getattr(want, f)[:n].numpy(),
                                      err_msg=f)


def _predict(fields, table):
    tree = tree_from_numpy(fields, int(fields["n_nodes"]))
    return predict_bins(tree, table.bins, table.n_num, device="cpu").numpy()


def _expect_collectives(name, counts):
    """The path each variant must have taken, read off its collectives
    (a mesh dim of size 1 still runs its collectives)."""
    tags = {k.split("/")[1] for k in counts}
    data, model = name != "model_only", name != "data_only"
    hist_op = {"composed": "reduce_scatter_tensor",
               "padded": "reduce_scatter_tensor",
               "mixed_chunks": "reduce_scatter_tensor",
               "data_only": "reduce_scatter_tensor",
               "psum_sub": "all_reduce", "dense": "all_reduce"}
    if data:
        assert f"{hist_op[name]}/hist" in counts, counts
    assert ("hist" in tags) == data, counts
    assert ("select" in tags) == model and ("route" in tags) == model, counts
    assert ("counts" in tags) == (data and name != "dense"), counts


@pytest.mark.parametrize("name", CLS + ("padded",))
@pytest.mark.parametrize("world_name", ["2x2", "4x1", "1x4", "2x2x2"])
def test_classification_equals_local(problems, world, world_name, name):
    trees, counts, cases = world(world_name)
    _assert_same(trees[name][0], _local(problems, cases[name]))
    _expect_collectives(name, counts[0][name])
    assert counts[0]["collectives"] == {"ok": 1}


def test_mixed_chunks_fall_back_on_four_data_shards():
    """chunk_slots=20 on 4 data shards: 20 slots split, their 10 pairs do
    not, so subtracted chunks psum and the others reduce-scatter."""
    dist = DistConfig()
    assert scatter_ok(dist, 4, 20, use_sub=False)
    assert not scatter_ok(dist, 4, 20, use_sub=True)
    assert scatter_ok(dist, 2, 20, use_sub=True)
    assert not scatter_ok(DistConfig(slot_scatter=False), 1, 16, False)


@pytest.mark.parametrize("world_name", ["4x1", "2x2x2"])
def test_scattered_parent_rows_move_once(world, world_name):
    """Composed on 4 data shards, every chunk's pairs scatter: each parent
    row of a scattered level goes from the one rank that holds it to the
    one that needs it, so all ranks together send fewer bytes for the
    parent rows than one rank hands to the histogram reduce-scatter."""
    _, counts, _ = world(world_name)
    parent = [c["composed"].get("all_to_all_single/parent", [0, 0])[1]
              for c in counts]
    hist = counts[0]["composed"]["reduce_scatter_tensor/hist"][1]
    assert all(c["composed"]["all_to_all_single/parent"][0] > 0
               for c in counts)
    assert 0 < sum(parent) < hist


@pytest.mark.parametrize("name", ["weighted", "kernels_data_only"])
def test_weighted_and_kernel_builds_equal_local(problems, world, name):
    trees, _, cases = world("2x2")
    _assert_same(trees[name][0], _local(problems, cases[name]))


@pytest.mark.parametrize("name", ["regression", "regression_variance",
                                  "regression_padded"])
def test_moment_tasks_within_reference_tolerance(problems, world, name):
    trees, _, cases = world("2x2")
    want = _local(problems, cases[name])
    got = trees[name][0]
    if name == "regression_padded":
        # exact label sums: the padding rows' label bins and targets reach
        # no tree, which is the local one field for field
        _assert_same(got, want)
    table = problems["tables"][cases[name]["problem"]]
    y = problems["arrays"][cases[name]["y"]]
    p0 = predict_bins(want, table.bins, table.n_num, device="cpu").numpy()
    p1 = _predict(got, table)
    rmse = float(np.sqrt(((p0 - p1) ** 2).mean()))
    assert rmse < 0.05 * (float(np.std(y)) + 1e-9)
    assert abs(want.n_nodes - int(got["n_nodes"])) <= 0.05 * want.n_nodes + 8


@pytest.mark.parametrize("kind", ["int", "float"])
def test_build_batched_against_local_batched(problems, world, kind):
    trees, counts, cases = world("2x2")
    case = cases[f"batched_{kind}"]
    arr = problems["arrays"]
    table = problems["tables"]["cls"]
    want, _ = build_trees_batched(table, arr[case["y"]],
                                  TreeConfig(**case["cfg"]),
                                  sample_weight=arr[case["weights"]],
                                  device="cpu")
    got = trees[case["name"]]
    assert len(got) == 3
    for g, w in zip(got, want):
        assert w.n_nodes > 15
        if kind == "int":       # integer sums: exact in any order
            _assert_same(g, w)
        else:
            np.testing.assert_allclose(
                _predict(g, table),
                predict_bins(w, table.bins, table.n_num,
                             device="cpu").numpy(), rtol=1e-4, atol=1e-4)
    assert "reduce_scatter_tensor/hist" in counts[0][case["name"]]


def test_kernel_select_breaks_cross_shard_ties_like_the_reference(problems,
                                                                  world):
    """GT on feature 0 ties LE on feature 1.  Locally the split-scan rule
    takes the first feature (0, GT); across four feature shards the
    reference's rule takes the lowest op-major flat index (1, LE), which
    is also the flat argmax of the torch rule, sharded or not."""
    trees, _, cases = world("1x4")
    root = {sel: (int(trees[f"tie_{sel}"][0]["feat"][0]),
                  int(trees[f"tie_{sel}"][0]["op"][0]))
            for sel in ("torch", "kernel")}
    local = {sel: _local(problems, cases[f"tie_{sel}"])
             for sel in ("torch", "kernel")}
    assert root["kernel"] == (1, OP_LE)
    assert (int(local["kernel"].feat[0]), int(local["kernel"].op[0])) \
        == (0, OP_GT)
    assert root["torch"] == (1, OP_LE)
    _assert_same(trees["tie_torch"][0], local["torch"])
    assert trees["tie_kernel"][0]["score"][0] == local["kernel"].score[0]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """An in-process gloo group of one rank and its 1x1 mesh."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    store = tmp_path_factory.mktemp("one_rank") / "store"
    tdist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                             world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("backends", [("segment", "jnp", "torch"),
                                      ("pallas", "pallas", "kernel")])
def test_one_rank_equals_reference_sharded_build(problems, one_rank,
                                                 backends):
    """The reference's ``build_tree_distributed`` on a 1x1
    ``jax.sharding.Mesh`` (a plain Mesh: ``jax.make_mesh``'s explicit axes
    make the reference's parent-cache gather raise under jax 0.9) against
    the port's on a 1-rank group, composed layout."""
    jhist, jsel, tsel = backends
    cols, y = make_classification(600, 7, 3, seed=9, n_cat_features=2,
                                  missing_frac=0.02)
    table = fit_bins(cols, max_num_bins=32)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    want = jbuild_dist(table, y, JConfig(**BASE, hist_backend=jhist,
                                         select_backend=jsel),
                       mesh=jmesh, dist=JDist(), n_classes=3)
    got = build_tree_distributed(
        _port(table), y, TreeConfig(**BASE, hist_backend=(
            "kernel" if jhist == "pallas" else jhist), select_backend=tsel),
        mesh=one_rank, dist=DistConfig(), n_classes=3, device="cpu")
    assert got.n_nodes == want.n_nodes > 50
    n = want.n_nodes
    for f in TREE_FIELDS:
        if f != "score":
            np.testing.assert_array_equal(getattr(got, f)[:n].numpy(),
                                          np.asarray(getattr(want, f))[:n],
                                          err_msg=f)
    # the split score is a float heuristic of each package's own log
    np.testing.assert_allclose(got.score[:n].numpy(),
                               np.asarray(want.score)[:n], rtol=1e-6)


def test_mesh_device_must_match(problems, one_rank):
    with pytest.raises(ValueError, match="mesh is on 'cpu'"):
        DistributedBuilder(problems["tables"]["cls"], TreeConfig(),
                           mesh=one_rank, n_classes=3, device="meta")
    with pytest.raises(ValueError, match="not in"):
        DistributedBuilder(problems["tables"]["cls"], TreeConfig(),
                           mesh=one_rank, dist=DistConfig(data_axes=("pod",)),
                           n_classes=3, device="cpu")


def test_only_the_sharded_build_counts_children_with_torch_ops(
        problems, one_rank, monkeypatch):
    """A local build on the ``kernel`` backend (single tree and class-
    batched) leaves the smaller-child choice to the histogram launch and
    never calls ``smaller_child_mask``; the sharded build on a 1x1 mesh
    still does (its counts are psum'd over the data axes first), and
    grows the same tree."""
    from repro_torch.core import tree as tree_mod
    table, y = problems["tables"]["cls"], problems["arrays"]["cls/y"]
    cfg = TreeConfig(**BASE, **KERNELS)
    real = tree_mod.smaller_child_mask

    def refuse(*a, **k):
        raise AssertionError("a local build called smaller_child_mask")

    monkeypatch.setattr(tree_mod, "smaller_child_mask", refuse)
    local = build_tree(table, y, cfg, n_classes=3, device="cpu")
    z = problems["arrays"]["cls/z_int"]
    build_trees_batched(table, z, TreeConfig(
        **BASE, **KERNELS, task="regression_variance"),
        sample_weight=problems["arrays"]["cls/h_int"], device="cpu")
    calls = []

    def counted(*a, **k):
        calls.append(a[1])
        return real(*a, **k)

    monkeypatch.setattr(tree_mod, "smaller_child_mask", counted)
    got = build_tree_distributed(table, y, cfg, mesh=one_rank,
                                 dist=DistConfig(), n_classes=3,
                                 device="cpu")
    assert calls
    assert got.n_nodes == local.n_nodes > 50
    for f in TREE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(local, f)), f
