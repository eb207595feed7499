"""The sLSTM's local block (``models/xlstm.py::_slstm_block_sharded``) on
gloo worlds, held against the port's one-rank path.

xlstm-smoke (d_model 64, d_i = 128) on a 2x2 and a 1x4 world, both
started together; every rank runs its one-rank comparison itself:

* the block alone: the forward, the gradient of ``x`` and of every weight
  (this rank's block of each, ``w_gates`` included: its columns come by an
  all-to-all whose backward must bring each rank's gradient home), and a
  decode step from a whole state, within the f32 mesh tolerance of
  tests/test_torch_lm_mesh.py (1e-5 of scale); the collectives of each
  phase as predicted: forward one ``slstm`` all-to-all (the gate columns)
  and one ``slstm`` psum (the output), backward the inverse all-to-all
  and the psum of ``x``'s gradient (in the engine's order), decode the
  forward's two and one ``slstm`` all-gather of the new state; no
  ``gather`` of ``w_up`` / ``w_down``;
* a model of two sLSTM layers: forward and decode (that file's f32
  bounds), and two train steps (tests/test_torch_train_mesh.py's bounds),
  with no ``gather`` call at all and the ``slstm`` calls the layer count
  predicts.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
from _lm_worlds import start_lm_world, wait_world  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402

F32_SCALE_TOL = 1e-5
F32_DECODE_SCALE_TOL = 1e-3
LR, REL, WELL_TOL = 3e-4, 1e-6, 1e-5
SLSTM_ONLY = dict(dtype="float32", pattern=("slstm",), n_layers=2)
A2A, PSUM, GATHER = (["all_to_all_single", "slstm"], ["all_reduce", "slstm"],
                     ["all_gather_into_tensor", "slstm"])


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cases():
    return [dict(kind="slstm", arch="xlstm_125m", name="block",
                 replace=dict(dtype="float32"), batch=4, seq=24),
            dict(kind="lm", arch="xlstm_125m", name="lm", replace=SLSTM_ONLY,
                 batch=4, seq=16, gen=2),
            dict(kind="train", arch="xlstm_125m", name="train",
                 replace=SLSTM_ONLY, batch=4, seq=16)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slstm_worlds")
    started = {s: start_lm_world(tmp / s, shape, _cases())
               for s, shape in (("2x2", (2, 2)), ("1x4", (1, 4)))}
    return {s: wait_world(h) for s, h in started.items()}


@pytest.mark.parametrize("world", ["2x2", "1x4"])
def test_block_forward_gradients_and_decode(worlds, world):
    ranks, infos = worlds[world]
    for r, (o, info) in enumerate(zip(ranks, infos)):
        where = f"{world} rank {r}"
        err = _rel(o["block/fwd_got"], o["block/fwd_want"])
        assert err <= F32_SCALE_TOL, (where, "forward", err)
        for k in ("x", "w_up", "w_gates", "w_down"):
            got, want = o[f"block/grad_{k}_got"], o[f"block/grad_{k}_want"]
            assert got.shape == want.shape, (where, k)
            err = _rel(got, want)
            assert err <= F32_SCALE_TOL, (where, "grad", k, err)
        for i in range(3):                 # output, new c, new n (whole)
            err = _rel(o[f"block/dec{i}_got"], o[f"block/dec{i}_want"])
            assert err <= F32_SCALE_TOL, (where, "decode", i, err)
        assert o["block/dec1_got"].shape == (4, 128)
        log = info["block"]
        assert log["forward"] == [A2A, PSUM], (where, log)
        assert sorted(log["backward"]) == [PSUM, A2A], (where, log)
        assert log["decode"] == [A2A, PSUM, GATHER], (where, log)


@pytest.mark.parametrize("world", ["2x2", "1x4"])
def test_block_runs_on_the_rules_slices(worlds, world):
    """``w_up`` / ``w_gates`` column-split and ``w_down`` row-split over
    ``model``, as the reference's rules put them (the rules themselves are
    held against the reference in tests/test_torch_sharding.py), and each
    rank's gradient block of that shape."""
    ranks, infos = worlds[world]
    m = {"2x2": 2, "1x4": 4}[world]
    assert infos[0]["block"]["specs"] == {"w_up": [None, "model"],
                                          "w_gates": [None, "model"],
                                          "w_down": ["model", None]}
    for o in ranks:
        assert o["block/grad_w_up_got"].shape == (64, 128 // m)
        assert o["block/grad_w_gates_got"].shape == (64, 3 * 128 // m)
        assert o["block/grad_w_down_got"].shape == (128 // m, 64)


@pytest.mark.parametrize("world", ["2x2", "1x4"])
def test_slstm_model_forward_and_decode(worlds, world):
    ranks, infos = worlds[world]
    for r, o in enumerate(ranks):
        where = f"{world} rank {r}"
        err = _rel(o["lm/fwd_got"], o["lm/fwd_want"])
        assert err <= F32_SCALE_TOL, (where, "forward", err)
        err = _rel(o["lm/dec_got"], o["lm/dec_want"])
        assert err <= F32_DECODE_SCALE_TOL, (where, "decode", err)
        np.testing.assert_array_equal(o["lm/tok_got"], o["lm/tok_want"],
                                      err_msg=where)
    counts = infos[0]["lm"]
    layers = SLSTM_ONLY["n_layers"]
    assert not any(k.endswith("/gather") for k in counts), counts
    steps = counts["all_gather_into_tensor/slstm"][0] // layers
    assert steps > 0 and counts["all_gather_into_tensor/slstm"][0] == (
        steps * layers)
    # one forward, then a state gather at every decode step
    for k in ("all_to_all_single/slstm", "all_reduce/slstm"):
        assert counts[k][0] == layers * (1 + steps), (k, counts)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _init_leaves():
    """The train case's state before its steps (seed 0, as the world's)."""
    cfg = dataclasses.replace(configs.get_smoke("xlstm_125m"), **SLSTM_ONLY)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    return [np.asarray(x, np.float32)
            for x in _leaves(M.train_state_to_numpy(state))]


def _whole_state_leaves(o, prefix):
    keys = sorted(int(k.rsplit("/", 1)[1]) for k in o
                  if k.startswith(prefix + "/"))
    return [o[f"{prefix}/{i}"] for i in keys]


@pytest.mark.parametrize("world", ["2x2", "1x4"])
def test_slstm_model_train_steps(worlds, world):
    """Two steps: loss and grad norm within 1e-6 relative, the gathered
    parameters and moments within tests/test_torch_train_mesh.py's bounds
    (1e-5 where both steps moved an entry by about lr the same way, 4 lr +
    1e-5 elsewhere, where Adam's direction is ill-conditioned), and the
    collectives of a step: per sLSTM layer and step, two all-to-alls and
    two psums (the block's forward and backward), no ``gather``."""
    ranks, infos = worlds[world]
    info = infos[0]["train"]
    np.testing.assert_allclose(info["got"], info["want"], rtol=REL, atol=0)
    init = _init_leaves()
    for o in ranks:
        want = _whole_state_leaves(o, "train/want")
        got = _whole_state_leaves(o, "train/got")
        assert len(init) == len(want) == len(got)
        wells = 0
        for a, w, g in zip(init, want, got):
            if a.shape != w.shape:         # the step counter
                np.testing.assert_array_equal(g, w)
                continue
            well = np.abs(w - a) / LR >= 1.98
            d = np.abs(g - w)
            if well.any():
                wells += int(well.sum())
                assert d[well].max() <= WELL_TOL, float(d[well].max())
            assert d.max() <= 4 * LR + WELL_TOL, float(d.max())
        assert wells, "no entry moved by 2 lr: the tight bound held nothing"
    layers, steps = SLSTM_ONLY["n_layers"], 2
    assert not any(k.endswith("/gather") for k in info), info
    assert info["all_to_all_single/slstm"][0] == 2 * layers * steps
    assert info["all_reduce/slstm"][0] == 2 * layers * steps


def test_gate_slices_on_one_rank_is_the_identity_both_ways(tmp_path):
    """On a one-rank model axis (an in-process 1-rank gloo group) the
    exchange moves every chunk to itself: the columns come back as they
    are, and the gradient in its own layout (a transposed gradient stays
    transposed)."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import mesh_axes
    gen = torch.Generator().manual_seed(1)
    w = torch.randn((6, 12), generator=gen, requires_grad=True)
    g = torch.randn((12, 6), generator=gen).t()
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                             rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        SH.set_activation_axes(mesh_axes(mesh), mesh)
        SH.COMM.log = []
        out = SH.gate_slices(w, 3, "slstm")
        (gw,) = torch.autograd.grad(out, w, g)
        log = [(c.op, c.tag) for c in SH.COMM.log]
    finally:
        SH.set_activation_axes(None, None)
        tdist.destroy_process_group()
    assert torch.equal(out, w) and torch.equal(gw, g)
    assert gw.stride() == g.stride()
    assert log == [("all_to_all_single", "slstm")] * 2


@pytest.mark.parametrize("m", [2, 3, 4, 16])
def test_gate_routes_move_each_chunk_to_the_rank_that_needs_it(m):
    """``_gate_routes``: every rank sends its 3 chunks and receives its
    i / f / o chunks; received in rank order they are in gate order."""
    held = {r: [3 * r + j for j in range(3)] for r in range(m)}
    routes = {r: SH._gate_routes(3, m, r) for r in range(m)}
    for r in range(m):
        order, send, recv = routes[r]
        assert sum(send) == sum(recv) == 3
        sent = [held[r][j] for j in order]
        assert [q % m for q in sent] == sorted(q % m for q in sent)
        got = [q for s in range(m) for q in
               [held[s][j] for j in routes[s][0]] if q % m == r]
        assert got == [r, m + r, 2 * m + r]
        assert recv == [sum(q // 3 == s for q in got) for s in range(m)]
