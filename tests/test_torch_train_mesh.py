"""The sharded train step, its checkpoints and the launchers on gloo
worlds, held against the port's one-rank path.

* Two train steps of smoke configs in f32 activations on a 2x2 world
  (gemma: heads path; smollm: the sequence-parallel fallback and the
  streamed CE on a vocab block; recurrentgemma: RG-LRU on width slices;
  xlstm: gathered blocks) and on a 2x1 world with
  ``param_sharding="fsdp"``, against two one-rank steps from the same
  weights and batches: loss and grad norm within 1e-6 relative, the
  gathered parameters and moments within tests/test_torch_train.py's
  step tolerances (1e-5 where both steps are well conditioned, 4 lr +
  1e-5 elsewhere: at a gradient's rounding noise Adam's direction
  g / (|g| + eps) can move by up to 2 a step).  The ``"grad"`` reduce
  sends exactly half the bytes with ``grad_dtype="bfloat16"``.
* Checkpoints: the 2x2 state written by rank 0 restores on one process
  equal to the gathered state bit for bit, and a one-process checkpoint
  restores on the 2x2 world equal to the blocks of the whole state.
* The launchers: ``launch.serve`` and ``launch.train --steps 2`` in a
  2-rank world with ``--mesh local`` (a (1, 2) mesh) give the no-mesh
  run's tokens, its first loss within 1e-6 and its second within
  tests/test_torch_train.py's bf16 step tolerance, 5e-2 (2.5e-4
  measured: the launcher's smoke config has bf16 activations).
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
from repro_torch.checkpoint import (restore_train_state,  # noqa: E402
                                    save_train_state)
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402

CPU = "cpu"
LR = 3e-4
REL = 1e-6
WELL_TOL = 1e-5
F32 = dict(dtype="float32")
SERVE = ["--arch", "smollm-360m", "--smoke", "--batch", "2",
         "--prompt-len", "8", "--gen", "6", "--device", CPU]
TRAIN = ["--arch", "smollm-360m", "--smoke", "--steps", "2", "--batch", "2",
         "--seq", "16", "--device", CPU]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _state_leaves(o, prefix):
    keys = sorted((int(k.rsplit("/", 1)[1]) for k in o
                   if k.startswith(prefix + "/")))
    return [o[f"{prefix}/{i}"] for i in keys]


def _one_process_ckpt(directory):
    """A one-process checkpoint of smollm-smoke (f32) after one step."""
    cfg = dataclasses.replace(configs.get_smoke("smollm_360m"), **F32)
    state = init_train_state(cfg, torch.Generator().manual_seed(3), CPU)
    state, _ = make_train_step(cfg)(state, launch_train.synthetic_lm_batch(
        cfg, 4, 16, 5, device=CPU))
    save_train_state(state, str(directory), 1, data_offset=1)


def _init_leaves(arch, replace):
    cfg = dataclasses.replace(configs.get_smoke(arch), **replace)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), CPU)
    return [np.asarray(x, np.float32)
            for x in _leaves(M.train_state_to_numpy(state))]


def _check_steps(name, arch, replace, o, info, bf16_grads=False):
    """Loss, grad norm, parameters and moments of the two steps.  With
    bf16 gradients the mesh sums the data blocks' gradients in bf16 (cast
    before the reduce, as the reference) where one rank casts their f32
    sum: the norm and the steps then agree to a bf16 ulp (2**-7), and
    only the first loss, which precedes any update, to 1e-6."""
    want, got = np.asarray(info["want"]), np.asarray(info["got"])
    if bf16_grads:
        np.testing.assert_allclose(got[0, 0], want[0, 0], rtol=REL)
        np.testing.assert_allclose(got, want, rtol=2 ** -7, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=REL, atol=0, err_msg=name)
    for a, w, g in zip(_init_leaves(arch, replace),
                       _state_leaves(o, name + "/want"),
                       _state_leaves(o, name + "/got")):
        if a.shape != w.shape:         # the step counter
            np.testing.assert_array_equal(g, w)
            continue
        moved = np.abs(w - a) / LR
        well = moved >= 1.98            # both steps at |u| ~ 1, same sign
        d = np.abs(g - w)
        if well.any() and not bf16_grads:
            assert d[well].max() <= WELL_TOL, (name, float(d[well].max()))
        assert d.max() <= 4 * LR + WELL_TOL, (name, float(d.max()))


def test_train_steps_checkpoints_and_launchers_on_worlds(tmp_path):
    one = tmp_path / "one_ckpt"
    _one_process_ckpt(one)
    mesh_ckpt = tmp_path / "mesh_ckpt"
    c22 = [dict(kind="train", arch=a, name=a, batch=4, seq=16, replace=F32)
           for a in ("gemma_7b", "smollm_360m", "recurrentgemma_2b",
                     "xlstm_125m")]
    c22.append(dict(kind="train", arch="gemma_7b", name="gemma_bf16_grads",
                    batch=4, seq=16, replace=F32, grad_dtype="bfloat16"))
    c22[1].update(replace=dict(F32), ckpt=str(mesh_ckpt), one_ckpt=str(one))
    fsdp = dict(F32, param_sharding="fsdp")
    c21 = [dict(kind="train", arch=a, name=a, batch=4, seq=16, replace=fsdp)
           for a in ("gemma_7b", "smollm_360m")]
    launch = [dict(kind="launch", name="launch", serve=SERVE, train=TRAIN)]
    worlds = {"2x2": start_lm_world(tmp_path / "w22", (2, 2), c22),
              "2x1": start_lm_world(tmp_path / "w21", (2, 1), c21),
              "1x2": start_lm_world(tmp_path / "w12", (1, 2), launch)}
    # the no-mesh launcher runs, in this process, while the worlds run
    plain_tokens = launch_serve.serve_lm(
        launch_serve.build_parser().parse_args(SERVE), CPU)["tokens"]
    res = launch_train.train_lm(launch_train.build_parser().parse_args(TRAIN),
                                CPU)
    plain_losses = [float(m["loss"]) for m in res["metrics"]]

    ranks, infos = wait_world(worlds["2x2"])
    for c in c22:
        for o in ranks:
            _check_steps(c["name"], c["arch"], c["replace"], o,
                         infos[0][c["name"]], "grad_dtype" in c)
    f32_bytes = infos[0]["gemma_7b"]["all_reduce/grad"][1]
    bf16_bytes = infos[0]["gemma_bf16_grads"]["all_reduce/grad"][1]
    assert bf16_bytes * 2 == f32_bytes, (bf16_bytes, f32_bytes)
    assert infos[0]["smollm_360m"]["restored_blocks_equal"]
    for info in infos:                  # psums only: one tensor never
        assert info["gemma_7b"]["all_reduce/grad"][0] == 2   # a collective

    # the mesh checkpoint on one process: the gathered state, bit for bit
    cfg = dataclasses.replace(configs.get_smoke("smollm_360m"), **F32)
    tmpl = init_train_state(cfg, torch.Generator().manual_seed(9), CPU)
    back, manifest = restore_train_state(tmpl, str(mesh_ckpt))
    assert manifest["extra"]["data_offset"] == 2
    got = [np.asarray(x, np.float32)
           for x in _leaves(M.train_state_to_numpy(back))]
    for a, b in zip(got, _state_leaves(ranks[0], "smollm_360m/got")):
        np.testing.assert_array_equal(a, b)

    ranks, infos = wait_world(worlds["2x1"])
    for c in c21:
        for o in ranks:
            _check_steps(c["name"], c["arch"], c["replace"], o,
                         infos[0][c["name"]])
        counts = infos[0][c["name"]]
        assert counts["all_gather_into_tensor/fsdp"][0] > 0
        assert counts["reduce_scatter_tensor/fsdp_grad"][0] > 0

    ranks, infos = wait_world(worlds["1x2"])
    for r, (o, info) in enumerate(zip(ranks, infos)):
        np.testing.assert_array_equal(o["launch/tokens"],
                                      plain_tokens.numpy(), err_msg=str(r))
        assert info["launch/serve_axes"] == {"data": 1, "model": 2}
        # the launcher's smoke config runs bf16 activations: the first
        # loss precedes any update, the second is held to the bf16 step
        # tolerance of tests/test_torch_train.py
        losses = info["launch"]["losses"]
        np.testing.assert_allclose(losses[0], plain_losses[0], rtol=REL)
        np.testing.assert_allclose(losses, plain_losses, rtol=5e-2,
                                   atol=5e-2)
        assert info["launch"]["counts"]["all_reduce/grad"][0] == 2


def test_data_parallel_reduce_keeps_each_gradients_layout():
    """The bucketed ``"grad"`` psum hands each gradient back in the
    layout autograd made it in (a transposed embedding gradient stays
    transposed): a sum over it (the global norm) may round by its
    strides, so one data rank's step equals the no-mesh step bit for bit
    (chip_smoke phase ``mesh``, xlstm-125m's tied embedding).  Recorded on
    a 2x1 mesh, whose psum returns its input."""
    from repro_torch.core.collectives import RecordingCollectives
    from repro_torch.models import sharding as SH
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import reduce_data_parallel
    gen = torch.Generator().manual_seed(0)
    grads = {"t": torch.randn((7, 5), generator=gen).t(),
             "c": torch.randn((4, 6), generator=gen),
             "p": torch.randn((2, 3, 4), generator=gen).permute(2, 0, 1)}
    specs = {n: (None,) * g.dim() for n, g in grads.items()}
    comm = RecordingCollectives((("data", 2), ("model", 1)))
    try:
        SH.set_activation_axes(SH.MeshAxes(sizes={"data": 2, "model": 1}),
                               mesh=comm.mesh, comm=comm)
        got = reduce_data_parallel(grads, specs)
        assert [(c.op, c.tag) for c in comm.log] == [("all_reduce", "grad")]
        norm = global_norm(got, specs)
    finally:
        SH.set_activation_axes(None, None)
    for n, g in grads.items():
        assert torch.equal(got[n], g) and got[n].stride() == g.stride(), n
    assert torch.equal(norm, global_norm(grads))
