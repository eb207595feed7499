"""The port's sharded boosting loop (``GradientBoostedTrees.fit(mesh=)``, the
sharded GOSS sampler and score walk, ``RandomForest.fit(mesh=)``,
``sweep(tree, ..., mesh=)``) against the reference and the port's local
loop: the counterpart of ``tests/test_dist_goss.py``.

(a) The stage functions and ``goss_sample_sharded_ref``, fed the
reference's ``fold_in`` uniforms and leverages at 2 and 4 shards, give the
reference's weights bit for bit (a logistic round 0 with every leverage
tied, random leverages, ``top_rate = 0``, a shard whose pool is smaller
than its quota).  (b)-(g) run on gloo worlds of CPU processes
(``_dist_worlds.FIT_SCRIPT``, one run per layout): the sampler's selection
equals ``goss_sample_sharded_ref``'s and its only collective is one scalar
pmax per data axis; the walk psums only one int32 bit per row and step over
the model axis; logistic / weighted / softmax GOSS fits equal the port's
local loop fed the same decisions to the reference's float contract (max
5e-2, mean 5e-3 on probabilities), two mesh fits are bit-identical, an
unsampled squared-loss fit is within ``0.05 * std(y)`` RMSE of the local
fit; with the reference's uniforms injected the 2x2 fit's round-0
selection equals the reference's own 2x2 mesh fit's (a forced-4-device
subprocess on a plain ``jax.sharding.Mesh``); the forest equals the local
forest field for field; the sharded grid equals the local sweep's exactly,
and a mesh sweep of an ensemble raises.  Every rank must return the same
trees, leaf labels and scores.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import fit_bins  # noqa: E402
from repro.core import forest as jforest  # noqa: E402
from repro.data import make_regression  # noqa: E402
from repro_torch.core import (GossConfig, GradientBoostedTrees,  # noqa: E402
                              RandomForest, SweepSpace, TreeConfig,
                              build_tree, build_trees_batched, get_loss,
                              predict_bins, sweep, walk_class_trees)
from repro_torch.core import forest  # noqa: E402
from repro_torch.core.binning import BinnedTable  # noqa: E402
from repro_torch.core.forest import (_goss_shard_boundary,  # noqa: E402
                                     _goss_shard_weights, _round_seed,
                                     goss_sample_sharded_ref)

from _dist_worlds import (FIELDS, FIT_SCRIPT, SRC, start_world,  # noqa: E402
                          wait_world)

CFG = dict(max_depth=5, task="regression_variance", chunk_slots=64)
GOSS = (0.2, 0.2)
N_TREES, LR = 3, 0.3


def _port(table):
    return BinnedTable(bins=np.asarray(table.bins),
                       n_num=np.asarray(table.n_num),
                       n_cat=np.asarray(table.n_cat), metas=[],
                       n_bins=int(table.n_bins))


def _ref_uniforms(seed, n_rounds, d_shards, m_loc):
    """The reference's per-round, per-shard draws: ``split`` once a round,
    then ``uniform(fold_in(sub, shard))`` (``make_sharded_sampler``)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        out.append([np.asarray(jax.random.uniform(
            jax.random.fold_in(sub, i), (m_loc,))) for i in range(d_shards)])
    return np.asarray(out, np.float32)                      # [R, D, m_loc]


# ---------------------------------------------------------------------------
# (a) the stage functions, in process
# ---------------------------------------------------------------------------

def _stage_case(case, d_shards):
    """(leverage [m_pad], m_valid, GossConfig) of a named case."""
    rng = np.random.default_rng(d_shards)
    if case == "round0_tied":       # a logistic round 0: |g| sqrt(h) = 0.25
        return np.full(400, 0.25, np.float32), 400, GossConfig(0.2, 0.2)
    if case == "random":            # with ties among the larger values
        lv = rng.normal(size=400).astype(np.float32)
        lv[::7] = 1.5
        return lv, 397, GossConfig(0.2, 0.3)
    if case == "top_rate_0":
        return rng.normal(size=400).astype(np.float32), 400, \
            GossConfig(0.0, 0.3)
    # r < q_oth: the last shards hold few (or no) valid rows
    return rng.normal(size=400).astype(np.float32), 220, GossConfig(0.2, 0.5)


STAGE_CASES = ("round0_tied", "random", "top_rate_0", "pool_below_quota")


@pytest.mark.parametrize("d_shards", [2, 4])
@pytest.mark.parametrize("case", STAGE_CASES)
def test_stages_equal_the_reference_given_its_uniforms(monkeypatch, case,
                                                       d_shards):
    rank, m_valid, goss = _stage_case(case, d_shards)
    q_top, q_oth = goss.shard_quota(m_valid, d_shards)
    jq = jforest.GossConfig(goss.top_rate, goss.other_rate)
    assert jq.shard_quota(m_valid, d_shards) == (q_top, q_oth)
    m_loc = rank.shape[0] // d_shards
    u = _ref_uniforms(3, 1, d_shards, m_loc)[0]
    key = jax.random.split(jax.random.PRNGKey(3))[1]
    want = np.asarray(jforest.goss_sample_sharded_ref(
        jnp.asarray(rank), key, d_shards=d_shards, m_valid=m_valid,
        q_top=q_top, q_oth=q_oth))
    monkeypatch.setattr(forest, "_shard_uniforms",
                        lambda rs, i, n, dev: torch.from_numpy(u[i]))
    got = goss_sample_sharded_ref(rank, 0, d_shards=d_shards,
                                  m_valid=m_valid, q_top=q_top, q_oth=q_oth,
                                  device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() <= (q_top + q_oth) * d_shards
    if case == "pool_below_quota":
        # the last shard with valid rows draws its whole pool (r < q_oth)
        lo = (m_valid - 1) // m_loc * m_loc
        assert m_valid - lo < q_oth
        assert (got[lo:m_valid] > 0).all() and (got[m_valid:] == 0).all()
    else:
        # the stratified amplification keeps the selected weight at m
        assert abs(float(got.sum()) - m_valid) < 1e-3 * m_valid
    # each stage alone, shard by shard
    valid = np.arange(rank.shape[0]) < m_valid
    lv = np.where(valid, np.abs(rank), -1.0).astype(np.float32)
    lv = lv.reshape(d_shards, m_loc)
    uu = np.where(lv >= 0, u, -1.0).astype(np.float32)
    tau_j = max(float(jforest._goss_shard_boundary(jnp.asarray(x), q_top))
                for x in lv)
    tau_t = max(float(_goss_shard_boundary(torch.from_numpy(x), q_top))
                for x in lv)
    assert tau_j == tau_t
    for x, v in zip(lv, uu):
        np.testing.assert_array_equal(
            _goss_shard_weights(torch.from_numpy(x), torch.from_numpy(v),
                                torch.tensor(tau_t), q_top, q_oth).numpy(),
            np.asarray(jforest._goss_shard_weights(
                jnp.asarray(x), jnp.asarray(v), jnp.float32(tau_j), q_top,
                q_oth)))


def test_shard_quota_is_the_reference_ceil_split():
    for m, d in [(1200, 2), (1200, 4), (7, 4), (3, 8)]:
        for a, b in [(0.2, 0.2), (0.0, 0.5), (0.5, 0.5)]:
            assert GossConfig(a, b).shard_quota(m, d) == \
                jforest.GossConfig(a, b).shard_quota(m, d)


# ---------------------------------------------------------------------------
# (b)-(g): gloo worlds, and the reference's own 2x2 mesh fit
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core import BinnedTable, GossConfig, GradientBoostedTrees, TreeConfig
from repro.core.distributed import DistConfig

assert len(jax.devices()) == 4
d = np.load(sys.argv[1])
table = BinnedTable(bins=d["reg/bins"], n_num=d["reg/n_num"],
                    n_cat=d["reg/n_cat"], metas=[], n_bins=int(d["reg/n_bins"]))
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
roots = []
def root(state):
    if state.depth == 2:
        roots.append(np.asarray(state.assign) >= 0)
ens = GradientBoostedTrees(n_trees=%(n)d, learning_rate=%(lr)r,
                           config=TreeConfig(**%(cfg)r),
                           goss=GossConfig(*%(goss)r), loss="logistic", seed=7)
ens.fit(table, d["reg/yb"], mesh=mesh, dist=DistConfig(), level_callback=root)
np.savez(sys.argv[2], roots=np.stack(roots),
         proba=np.asarray(ens.predict_proba(table.bins)))
""" % {"n": N_TREES, "lr": LR, "cfg": CFG, "goss": GOSS}


def _gbt(name, y, loss, seed, **kw):
    return dict(name=name, kind="gbt", problem="reg", y=y, loss=loss,
                seed=seed, n_trees=N_TREES, cfg=CFG, **kw)


WORLDS = {
    "2x2": ((2, 2), [
        dict(name="sampler0", kind="sampler", problem="reg", y="reg/yb",
             raw="reg/raw0", loss="logistic", goss=GOSS, seed=7,
             n_trees=1, cfg=CFG, round_seed=0),
        dict(name="sampler1", kind="sampler", problem="reg", y="reg/yb",
             raw="reg/raw1", loss="logistic", goss=GOSS, seed=7,
             n_trees=1, cfg=CFG, round_seed=1),
        _gbt("logistic", "reg/yb", "logistic", 7, goss=GOSS, repeat=True),
        _gbt("weighted", "reg/yb", "logistic", 7, goss=GOSS,
             weights="reg/sw"),
        _gbt("squared", "reg/y", "squared", 5),
        _gbt("ref_uniforms", "reg/yb", "logistic", 7, goss=GOSS,
             uniforms="ref/u"),
        _gbt("softmax", "reg/yc", "softmax", 3, goss=GOSS, weights="reg/sw"),
        dict(name="forest", kind="forest", problem="cls", y="cls/y",
             n_trees=3, seed=0, cfg=dict(max_depth=8, chunk_slots=64)),
        dict(name="sweep", kind="sweep", problem="cls", y="cls/y",
             val="val", val_y="val/y", mcw=[0.0, 2.0, 8.0],
             cfg=dict(max_depth=12, select_backend="torch")),
    ]),
    "4x1": ((4, 1), [
        dict(name="sampler0", kind="sampler", problem="reg", y="reg/yb",
             raw="reg/raw1", loss="logistic", goss=GOSS, seed=7,
             n_trees=1, cfg=CFG, round_seed=2),
        _gbt("logistic", "reg/yb", "logistic", 7, goss=GOSS),
        dict(name="sweep", kind="sweep", problem="cls", y="cls/y",
             val="val", val_y="val/y", mcw=[0.0, 2.0, 8.0],
             cfg=dict(max_depth=12, select_backend="torch")),
    ]),
}


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_goss")
    cols, y = make_regression(1200, 6, seed=3)
    reg = _port(fit_bins(cols, max_num_bins=32))
    y = np.asarray(y, np.float32)
    yb = (y > np.median(y)).astype(np.float32)
    yc = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(np.int64)
    rng = np.random.default_rng(0)
    cols2, y2 = make_regression(900, 5, seed=8)
    y2 = np.digitize(y2, np.quantile(y2, [0.3, 0.6])).astype(np.int64)
    both = _port(fit_bins(cols2, max_num_bins=32))
    cls = dataclasses.replace(both, bins=both.bins[:700])
    vbins = both.bins[700:]
    arrays = {"reg/y": y, "reg/yb": yb, "reg/yc": yc,
              "reg/raw0": np.zeros(1200, np.float32),
              "reg/raw1": rng.normal(size=1200).astype(np.float32),
              "reg/sw": rng.uniform(0.5, 2.0, 1200).astype(np.float32),
              "ref/u": _ref_uniforms(7, N_TREES, 2, 600),
              "cls/y": y2[:700], "val/bins": vbins, "val/y": y2[700:]}
    for p, t in (("reg", reg), ("cls", cls)):
        arrays.update({f"{p}/bins": t.bins, f"{p}/n_num": t.n_num,
                       f"{p}/n_cat": t.n_cat, f"{p}/n_bins": t.n_bins})
    path = tmp / "problem.npz"
    np.savez(path, **arrays)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(path),
                            str(tmp / "ref.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    handles = {w: start_world(tmp / w, shape, ("data", "model"), cases, path,
                              script=FIT_SCRIPT, timeout=240.0)
               for w, (shape, cases) in WORLDS.items()}
    worlds = {}
    try:
        for w, h in handles.items():
            try:
                worlds[w] = wait_world(h)
            except AssertionError as e:
                worlds[w] = e
        log = ref.communicate(timeout=240)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    ref_out = (dict(np.load(tmp / "ref.npz")) if ref.returncode == 0
               else AssertionError(log[-4000:]))
    return dict(tables={"reg": reg, "cls": cls}, arrays=arrays,
                worlds=worlds, ref=ref_out)


def _world(problem, name):
    """(rank-0 outputs, every rank's local outputs, counts by rank); every
    rank's replicated outputs (trees, labels, scores) must be equal."""
    got = problem["worlds"][name]
    if isinstance(got, AssertionError):
        raise got
    ranks, counts = got
    for r in range(1, len(ranks)):
        for key, v in ranks[0].items():
            if "/local/" not in key:
                np.testing.assert_array_equal(ranks[r][key], v,
                                              err_msg=f"rank {r} {key}")
    return ranks[0], ranks, counts


def _data_blocks(ranks, key, shape):
    """The data-shard blocks of a per-rank output, in data-shard order
    (model coordinate 0 of each data index; ranks are data-major)."""
    return np.concatenate([ranks[d * shape[1]][key] for d in range(shape[0])],
                          axis=-1)


def _local_loop(problem, y_key, loss, seed, d_shards, weights=None,
                uniforms=None):
    """The port's local loop fed the mesh fit's decisions: each round's
    sharded draw from ``goss_sample_sharded_ref`` (the same round seeds),
    a local build on the selected rows with the same weights, and the
    plain walk.  Returns (link-applied scores, selection masks)."""
    table = problem["tables"]["reg"]
    lo = get_loss(loss, n_classes=3) if loss == "softmax" else get_loss(loss)
    y = torch.as_tensor(problem["arrays"][y_key])
    sw = (torch.as_tensor(problem["arrays"][weights]) if weights else None)
    cfg = TreeConfig(**CFG)
    m = y.shape[0]
    m_pad = -(-m // d_shards) * d_shards
    q_top, q_oth = GossConfig(*GOSS).shard_quota(m, d_shards)
    base = lo.base_score(y)
    multi = loss == "softmax"
    raw = base[:, None].expand(3, m) if multi else base.expand(m)
    gen = torch.Generator().manual_seed(seed)
    masks, lr = [], torch.tensor(LR)
    for _ in range(N_TREES):
        g, h = lo.grad_hess(y, raw)
        z = lo.newton_target(g, h)
        if sw is not None:
            g, h = g * sw, h * sw
        rank = (torch.sqrt(torch.sum(g * g * h, dim=0)) if multi
                else g * torch.sqrt(h))
        w = goss_sample_sharded_ref(
            torch.nn.functional.pad(rank, (0, m_pad - m)), _round_seed(gen),
            d_shards=d_shards, m_valid=m, q_top=q_top, q_oth=q_oth,
            device="cpu")[:m]
        sel = torch.nonzero(w > 0)[:, 0]
        masks.append((w > 0).numpy())
        sub = dataclasses.replace(table, bins=table.bins[sel.numpy()])
        if multi:
            _, arrays = build_trees_batched(
                sub, z[:, sel], cfg, sample_weight=w[sel][None] * h[:, sel],
                device="cpu")
            raw = raw + lr * walk_class_trees(arrays, table.bins, table.n_num,
                                              num_steps=CFG["max_depth"])
        else:
            tree = build_tree(sub, z[sel], cfg, sample_weight=(w * h)[sel],
                              device="cpu")
            raw = raw + lr * predict_bins(tree, table.bins, table.n_num,
                                          num_steps=CFG["max_depth"],
                                          device="cpu")
    return lo.link(raw.T if multi else raw).numpy(), np.stack(masks)


def _float_contract(p_mesh, p_ref):
    """The reference's own contract on probabilities
    (``tests/test_dist_goss.py``): max 5e-2, mean 5e-3."""
    err = np.abs(p_mesh - p_ref)
    assert float(err.max()) < 5e-2, float(err.max())
    assert float(err.mean()) < 5e-3, float(err.mean())


def _link(loss, raw):
    raw = torch.as_tensor(raw)
    return (get_loss(loss, n_classes=3) if loss == "softmax"
            else get_loss(loss)).link(raw).numpy()


@pytest.mark.parametrize("world_name", ["2x2", "4x1"])
def test_sampler_selection_and_its_one_collective(problem, world_name):
    """(b) The sampler's selection and assign0 equal
    ``goss_sample_sharded_ref``'s for the same round seed, its weights are
    the reference weights times the hessian, and its only collective is
    one scalar pmax per data axis (``Collectives.log``)."""
    shape = WORLDS[world_name][0]
    _, ranks, counts = _world(problem, world_name)
    arr = problem["arrays"]
    lo = get_loss("logistic")
    y = torch.as_tensor(arr["reg/yb"])
    goss = GossConfig(*GOSS)
    q = goss.shard_quota(1200, shape[0])
    for case in (c for c in WORLDS[world_name][1] if c["kind"] == "sampler"):
        g, h = lo.grad_hess(y, torch.as_tensor(arr[case["raw"]]))
        want = goss_sample_sharded_ref(
            g * torch.sqrt(h), case["round_seed"], d_shards=shape[0],
            m_valid=1200, q_top=q[0], q_oth=q[1], device="cpu")
        w = _data_blocks(ranks, case["name"] + "/local/w", shape)
        a0 = _data_blocks(ranks, case["name"] + "/local/assign0", shape)
        np.testing.assert_array_equal(w > 0, want.numpy() > 0)
        np.testing.assert_array_equal(a0, np.where(want.numpy() > 0, 0, -1))
        np.testing.assert_array_equal(w, (want * h).numpy())
        for c in counts:
            assert c[case["name"]] == [["all_reduce", "goss", 4]]


def test_walk_psums_one_bit_per_row_and_step_over_the_model_axis(problem):
    """The walk's scores never leave their data shard: its collectives are
    ``max_depth`` int32 psums of the rank's own rows over the model axis,
    and its scores equal the local walk's."""
    shape = WORLDS["2x2"][0]
    _, ranks, counts = _world(problem, "2x2")
    table, arr = problem["tables"]["reg"], problem["arrays"]
    ens = GradientBoostedTrees(n_trees=1, config=TreeConfig(**CFG), seed=7,
                               loss="logistic", goss=GossConfig(*GOSS)).fit(
        table, arr["reg/yb"], device="cpu")
    want = predict_bins(ens.trees[0], table.bins, table.n_num,
                        num_steps=CFG["max_depth"], device="cpu").numpy()
    for name in ("sampler0", "sampler1"):
        got = _data_blocks(ranks, name + "/local/walk", shape)
        np.testing.assert_array_equal(got, want)
        for c in counts:
            assert c[name + "/walk"] == [["all_reduce", "walk",
                                          4 * 1200 // shape[0]]] \
                * CFG["max_depth"]


@pytest.mark.parametrize("world_name", ["2x2", "4x1"])
def test_logistic_goss_fit_equals_local_loop_fed_the_same_decisions(
        problem, world_name):
    """(c) The logistic GOSS mesh fit against the local loop fed the same
    draws: the selections exactly, the probabilities to the reference's
    float contract; the root level scatters at most (q_top + q_oth) *
    d_shards rows."""
    shape = WORLDS[world_name][0]
    out, ranks, counts = _world(problem, world_name)
    p_ref, masks = _local_loop(problem, "reg/yb", "logistic", 7, shape[0])
    roots = _data_blocks(ranks, "logistic/local/roots", shape)[:, :1200]
    np.testing.assert_array_equal(roots, masks)
    _float_contract(_link("logistic", out["logistic/raw"]), p_ref)
    q_top, q_oth = GossConfig(*GOSS).shard_quota(1200, shape[0])
    assert roots[0].sum() <= (q_top + q_oth) * shape[0] and \
        roots[0].sum() < 1200
    assert counts[0]["logistic"]["all_reduce/goss"][0] == N_TREES


def test_two_mesh_fits_are_bit_identical_and_the_ensemble_sweep_refuses(
        problem):
    out, _, _ = _world(problem, "2x2")
    np.testing.assert_array_equal(out["logistic/raw"],
                                  out["logistic/raw_again"])
    assert int(out["logistic/sweep_refused"]) == 1


def test_weighted_goss_fit_equals_local_loop(problem):
    """(c) with ``sample_weight``: the weight scales g and h after the
    Newton target, in the ranking and the build weights."""
    out, ranks, _ = _world(problem, "2x2")
    p_ref, masks = _local_loop(problem, "reg/yb", "logistic", 7, 2,
                               weights="reg/sw")
    np.testing.assert_array_equal(
        _data_blocks(ranks, "weighted/local/roots", (2, 2)), masks)
    _float_contract(_link("logistic", out["weighted/raw"]), p_ref)


def test_unsampled_squared_mesh_fit_within_tolerance_of_local_fit(problem):
    """(c) No GOSS, squared loss: every valid row at weight 1, no weight
    channel; RMSE within 0.05 * std(y) of the local fit."""
    out, _, _ = _world(problem, "2x2")
    table, y = problem["tables"]["reg"], problem["arrays"]["reg/y"]
    local = GradientBoostedTrees(n_trees=N_TREES, config=TreeConfig(**CFG),
                                 seed=5).fit(table, y, device="cpu")
    p0 = local.predict_raw(table.bins)
    rmse = float(np.sqrt(((p0 - out["squared/raw"]) ** 2).mean()))
    assert rmse < 0.05 * (float(np.std(y)) + 1e-9)


def test_softmax_goss_fit_equals_local_loop(problem):
    """(e) Three classes, one shared draw ranked by sqrt(sum_c g_c^2 h_c),
    ``build_batched`` and the class walk on the mesh."""
    out, ranks, _ = _world(problem, "2x2")
    p_ref, masks = _local_loop(problem, "reg/yc", "softmax", 3, 2,
                               weights="reg/sw")
    np.testing.assert_array_equal(
        _data_blocks(ranks, "softmax/local/roots", (2, 2)), masks)
    _float_contract(_link("softmax", out["softmax/raw"]), p_ref)
    assert sum(k.endswith("/feat") and k.startswith("softmax/")
               for k in out) == 3 * N_TREES


def test_reference_uniforms_give_the_reference_mesh_selection(problem):
    """(d) With the reference's per-shard uniforms injected through
    ``forest._shard_uniforms``, round 0's selection (every leverage tied)
    equals the reference's own 2x2 mesh fit's bit for bit; the later rounds
    and the probabilities meet the reference's float contract."""
    out, ranks, _ = _world(problem, "2x2")
    ref = problem["ref"]
    if isinstance(ref, AssertionError):
        raise ref
    roots = _data_blocks(ranks, "ref_uniforms/local/roots", (2, 2))
    np.testing.assert_array_equal(roots[0], ref["roots"][0])
    assert roots.shape == ref["roots"].shape
    _float_contract(_link("logistic", out["ref_uniforms/raw"]),
                    ref["proba"])


def test_mesh_forest_equals_local_forest(problem):
    """(f) Each bootstrapped, feature-masked tree through
    ``build_tree_distributed``: integer counts, so field for field."""
    out, _, _ = _world(problem, "2x2")
    table, y = problem["tables"]["cls"], problem["arrays"]["cls/y"]
    case = next(c for c in WORLDS["2x2"][1] if c["name"] == "forest")
    rf = RandomForest(n_trees=3, max_features=0.7,
                      config=TreeConfig(**case["cfg"]), seed=0).fit(
        table, y, device="cpu")
    for i, tree in enumerate(rf.trees):
        assert int(out[f"forest/tree{i}/n_nodes"]) == tree.n_nodes > 10
        for f in FIELDS:
            np.testing.assert_array_equal(
                out[f"forest/tree{i}/{f}"],
                getattr(tree, f)[:tree.n_nodes].numpy(), err_msg=f)
    np.testing.assert_array_equal(out["forest/votes"],
                                  rf.predict_raw(table.bins))


@pytest.mark.parametrize("world_name", ["2x2", "4x1"])
def test_mesh_sweep_equals_local_sweep(problem, world_name):
    """(g) Validation rows over the data axes, smin over the model axis:
    the classification grid equals the local sweep's exactly."""
    out, _, _ = _world(problem, world_name)
    table, arr = problem["tables"]["cls"], problem["arrays"]
    case = next(c for c in WORLDS[world_name][1] if c["name"] == "sweep")
    tree = build_tree(table, arr["cls/y"], TreeConfig(**case["cfg"]),
                      device="cpu")
    res = sweep(tree, arr["val/bins"], arr["val/y"], table.n_num,
                space=SweepSpace(mcw_values=tuple(case["mcw"])),
                device="cpu")
    assert res.metric.size >= 200
    for f in ("metric", "n_nodes", "walk_bytes", "dmax", "smin"):
        np.testing.assert_array_equal(out[f"sweep/{f}"],
                                      np.asarray(getattr(res, f)), err_msg=f)
