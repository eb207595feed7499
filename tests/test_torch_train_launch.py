"""Port parity for the LM training launcher and its checkpoints on the CPU:
``launch.train`` (``synthetic_lm_batch``, ``train_lm``, ``train_udt``,
``main``) and ``checkpoint.save_train_state`` / ``restore_train_state``,
against ``repro.launch.train`` and ``repro.checkpoint``.

Tolerances: the token stream and the restored states exact; the port's
own resume, and a killed launcher's, bit for bit; two steps continued in
the other package, with f32 activations: loss rtol 1e-5 a step,
parameters rtol = atol = 1e-5.
"""
import dataclasses
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.checkpoint import latest_step as jlatest_step
from repro.checkpoint import restore_train_state as jrestore_train_state
from repro.checkpoint import save_train_state as jsave_train_state
from repro.launch import train as jlaunch
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro.train import train_step as JT
from repro_torch import configs
from repro_torch.checkpoint import (latest_step, restore_train_state,
                                    save_train_state)
from repro_torch.launch import train as launch
from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train import train_step as T

CPU = "cpu"
LR = 1e-3
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _state_leaves(state):
    """Every leaf of a train state of either package, reference order."""
    tree = (M.train_state_to_numpy(state) if hasattr(state, "model")
            else state._asdict())
    return [_np(x) for x in jax.tree.leaves(tree)]


def _reference_draw(shape, step, seed, device):
    """The reference's frames / patches of ``step``, fed in at the seam."""
    del seed
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.key(step), shape))).to(device)


# -- the token stream ----------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm_360m", "hubert_xlarge",
                                  "paligemma_3b"])
def test_synthetic_lm_batch_is_the_reference_stream(arch, monkeypatch):
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    own = launch.synthetic_lm_batch(tcfg, 2, 16, 3, device=CPU)
    draw = launch._frontend_draw
    monkeypatch.setattr(launch, "_frontend_draw", _reference_draw)
    for step in (0, 3):
        want = jlaunch.synthetic_lm_batch(jcfg, 2, 16, step)
        got = launch.synthetic_lm_batch(tcfg, 2, 16, step, device=CPU)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == (torch.float32 if k in ("frames",
                                                           "patches")
                                    else torch.int32)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # without the seam: a torch generator seeded 17 + step, same shapes
    for k, v in own.items():
        assert v.shape == got[k].shape and v.dtype == got[k].dtype
    if "frames" in own or "patches" in own:
        k = "frames" if "frames" in own else "patches"
        again = draw(tuple(own[k].shape), 3, 17, CPU)
        assert torch.equal(own[k], again)


# -- checkpoints ------------------------------------------------------------------

def _jstep(cfg):
    return jax.jit(jmake_train_step(cfg, lr=LR))


def test_train_state_round_trip_and_layout(tmp_path):
    """The port's checkpoint restores bit for bit and has the reference's
    layout: the same keys, shapes and dtypes in the manifest."""
    tcfg = configs.get_smoke("smollm_360m")
    state = init_train_state(tcfg, torch.Generator().manual_seed(0), CPU)
    state, _ = make_train_step(tcfg, lr=LR)(
        state, launch.synthetic_lm_batch(tcfg, 2, 16, 0, device=CPU))
    save_train_state(state, str(tmp_path / "port"), 1, data_offset=1)
    assert latest_step(str(tmp_path / "port")) == 1
    template = init_train_state(tcfg, torch.Generator().manual_seed(5), CPU)
    restored, manifest = restore_train_state(template, str(tmp_path / "port"))
    assert manifest["extra"]["data_offset"] == 1
    assert int(restored.opt["step"]) == 1
    for a, b in zip(_state_leaves(state), _state_leaves(restored)):
        np.testing.assert_array_equal(a, b)
    jstate = jinit_train_state(jax.random.key(0), jconfigs.get_smoke(
        "smollm_360m"))
    jsave_train_state(jstate, str(tmp_path / "ref"), 1, data_offset=1)
    _, jmanifest = restore_train_state(template, str(tmp_path / "ref"))
    assert manifest["keys"] == jmanifest["keys"]


def test_port_resume_is_bit_exact(tmp_path):
    """4 steps straight against 2 + checkpoint + restore + 2 (gemma smoke,
    its own bf16 activations): the same parameters and moments."""
    cfg = configs.get_smoke("gemma_7b")
    step = make_train_step(cfg, lr=LR)

    def run(lo, hi, state):
        for i in range(lo, hi):
            state, _ = step(state, launch.synthetic_lm_batch(cfg, 2, 16, i,
                                                             device=CPU))
        return state

    fresh = lambda: init_train_state(  # noqa: E731
        cfg, torch.Generator().manual_seed(0), CPU)
    straight = run(0, 4, fresh())
    half = run(0, 2, fresh())
    save_train_state(half, str(tmp_path), 2, data_offset=2)
    resumed, m = restore_train_state(fresh(), str(tmp_path))
    resumed = run(m["extra"]["data_offset"], 4, resumed)
    for a, b in zip(_state_leaves(straight), _state_leaves(resumed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """tests/test_checkpoint.py's scenario across packages (gemma smoke, f32
    activations, its f32 state): one package trains 2 steps and writes
    step 2; the other restores it (exactly the writer's state) and trains
    steps 3-4, which match the writer's own straight run."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="float32") for c in (
        jconfigs.get_smoke("gemma_7b"), configs.get_smoke("gemma_7b")))
    jstate0 = jinit_train_state(jax.random.key(0), jcfg)
    tree0 = jax.tree.map(np.asarray, jstate0._asdict())
    jstep, tstep = _jstep(jcfg), make_train_step(tcfg, lr=LR)
    jbatch = lambda i: jlaunch.synthetic_lm_batch(jcfg, 2, 16, i)  # noqa: E731
    tbatch = lambda i: launch.synthetic_lm_batch(tcfg, 2, 16, i,  # noqa: E731
                                                 device=CPU)
    d = str(tmp_path)
    if writer == "reference":
        states, losses = [jstate0], []
        for i in range(4):
            s, m = jstep(states[-1], jbatch(i))
            states.append(s)
            losses.append(float(m["loss"]))
        jsave_train_state(states[2], d, 2, data_offset=2)
        template = M.train_state_from_numpy(tree0, tcfg, CPU)
        other, manifest = restore_train_state(template, d)
        assert latest_step(d) == 2
        for a, b in zip(_state_leaves(other), _state_leaves(states[2])):
            np.testing.assert_array_equal(a, b)
        for i in range(2, 4):
            other, m = tstep(other, tbatch(i))
            np.testing.assert_allclose(float(m["loss"]), losses[i], rtol=1e-5)
        mine, want = M.params_to_numpy(other.model), states[4].params
    else:
        state, losses = M.train_state_from_numpy(tree0, tcfg, CPU), []
        for i in range(4):
            state, m = tstep(state, tbatch(i))
            losses.append(float(m["loss"]))
            if i == 1:
                save_train_state(state, d, 2, data_offset=2)
                at_two = _state_leaves(state)
        assert jlatest_step(d) == 2
        other, manifest = jrestore_train_state(jstate0, d)
        for a, b in zip(_state_leaves(other), at_two):
            np.testing.assert_array_equal(a, b)
        for i in range(2, 4):
            other, m = jstep(other, jbatch(i))
            np.testing.assert_allclose(float(m["loss"]), losses[i], rtol=1e-5)
        mine, want = other.params, M.params_to_numpy(state.model)
    assert manifest["extra"]["data_offset"] == 2
    for a, b in zip(_np_leaves(mine), _np_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _np_leaves(tree):
    return [_np(x) for x in jax.tree.leaves(tree)]


def test_mlstm_gradient_is_finite_where_the_reference_is_nan():
    """xlstm's smoke config at the launcher's defaults (batch 8, seq 128,
    one 128-token mLSTM chunk), f32 activations: the reference's gradient
    is NaN (its where(mask, exp(dmat) * ig, 0) overflows above the
    diagonal, and 0 * inf in the backward), the port's is finite, with the
    reference's loss within rtol 1e-5 and its gradients where they are
    finite (below the overflow, seq 64) within atol 1e-5."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="float32") for c in (
        jconfigs.get_smoke("xlstm_125m"), configs.get_smoke("xlstm_125m")))
    jstate = jinit_train_state(jax.random.key(0), jcfg)
    model = M.train_state_from_numpy(jax.tree.map(np.asarray,
                                                  jstate._asdict()),
                                     tcfg, CPU).model
    vg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, jcfg, b)))
    for seq in (128, 64):
        jloss, jgrads = vg(jstate.params, jlaunch.synthetic_lm_batch(
            jcfg, 8, seq, 0))
        tloss, tgrads = T.loss_and_grads(
            model, launch.synthetic_lm_batch(tcfg, 8, seq, 0, device=CPU))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        port = _np_leaves(M._reference_layout(model,
                                              lambda n: _np(tgrads[n])))
        assert all(np.isfinite(g).all() for g in port)
        if seq == 128:
            assert not all(np.isfinite(g).all() for g in _np_leaves(jgrads))
        else:
            for a, b in zip(port, _np_leaves(jgrads)):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# -- the launcher -----------------------------------------------------------------

_KILL = r"""
import os, runpy, signal, sys
import repro_torch.checkpoint as C

saved = []
save = C.save_train_state

def save_then_die(*a, **kw):
    out = save(*a, **kw)
    saved.append(a[2])
    if len(saved) == 2:
        os.kill(os.getpid(), signal.SIGKILL)
    return out

C.save_train_state = save_then_die
sys.argv = ["repro_torch.launch.train"] + sys.argv[1:]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
print("UNREACHABLE: survived the second checkpoint")
"""


def test_sigkilled_launcher_resumes_bit_for_bit(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu`` killed
    (SIGKILL) right after its second checkpoint, then rerun with the same
    command: it resumes from step 4 and ends bit for bit where an
    uninterrupted run ends."""
    env = dict(os.environ, PYTHONPATH=SRC)
    flags = ["--smoke", "--device", "cpu", "--steps", "7", "--batch", "2",
             "--seq", "16", "--ckpt-every", "2"]
    killed, whole = str(tmp_path / "killed"), str(tmp_path / "whole")
    procs = [subprocess.Popen([sys.executable, "-c", _KILL, *flags,
                               "--ckpt-dir", killed], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True),
             subprocess.Popen([sys.executable, "-m",
                               "repro_torch.launch.train", *flags,
                               "--ckpt-dir", whole], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert procs[0].returncode == -signal.SIGKILL, outs[0]
    assert "UNREACHABLE" not in outs[0][0]
    assert procs[1].returncode == 0, outs[1]
    assert latest_step(killed) == 4
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *flags, "--ckpt-dir", killed], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "resumed from step 4" in r.stdout
    assert latest_step(killed) == latest_step(whole) == 7
    for d in (killed, whole):
        assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in (2, 4, 6, 7)]
    a = np.load(os.path.join(killed, "step_00000007", "shard_p0.npz"))
    b = np.load(os.path.join(whole, "step_00000007", "shard_p0.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_launcher_lm_mode_on_the_cpu(capsys):
    res = launch.train_lm(launch.build_parser().parse_args(
        ["--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
         "--device", "cpu"]), CPU)
    out = capsys.readouterr().out
    assert re.search(r"step +0 loss \d+\.\d+ gnorm", out)
    assert re.search(r"step +2 loss", out) and out.strip().endswith("done")
    assert res["start"] == 0 and len(res["metrics"]) == 3
    assert int(res["state"].opt["step"]) == 3
    assert all(np.isfinite(float(m["loss"])) for m in res["metrics"])
    with pytest.raises(RuntimeError, match="256 ranks"):
        launch.main(["--smoke", "--mesh", "prod", "--device", "cpu"])


def test_train_step_refused_under_a_larger_mesh():
    """Under a mesh the step runs the rank's sharded state
    (models.placement.shard_train_state); a whole state that was not cut
    to the mesh is refused, and nothing runs replicated in its place."""
    from repro_torch.core.collectives import RecordingCollectives
    cfg = configs.get_smoke("smollm_360m")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), CPU)
    batch = launch.synthetic_lm_batch(cfg, 2, 16, 0, device=CPU)
    comm = RecordingCollectives((("data", 1), ("model", 2)))
    SH.set_activation_axes(SH.MeshAxes(sizes={"data": 1, "model": 2}),
                           comm.mesh, comm)
    try:
        with pytest.raises(ValueError, match="shard_model"):
            make_train_step(cfg)(state, batch)
    finally:
        SH.set_activation_axes(None)


def _udt_lines(out):
    """The three result lines, timings dropped."""
    return [re.sub(r" in \d+\.\d+s", "", line)
            for line in out.strip().splitlines()]


def test_launcher_udt_mode_matches_the_reference(capsys):
    """``--arch udt --smoke``: the same nodes, depth, configs priced, best
    dmax / smin and test accuracy as the reference's launcher."""
    args = launch.build_parser().parse_args(["--arch", "udt", "--smoke",
                                             "--device", "cpu"])
    jlaunch.train_udt(args)
    want = _udt_lines(capsys.readouterr().out)
    res = launch.train_udt(args, CPU)
    got = _udt_lines(capsys.readouterr().out)
    assert got == want and len(got) == 3
    assert f"dmax={res['tune'].best_dmax}" in got[1]
    assert f"{res['test_acc']:.4f}" in got[2]
