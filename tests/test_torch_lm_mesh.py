"""The sharded LM's forward, decode and MoE mesh paths on gloo worlds,
held against the port's one-rank path and the reference's own sharded MoE.

* The ten smoke archs on a 2x2 and a 1x4 world (all archs in one world,
  both worlds started together): forward logits and the decode logits of
  a 4-token prefill against the no-mesh path on the rank's data block
  (an MoE's capacity depends on the tokens it routes together, so a data
  block is its own problem), and 2 greedy tokens equal.  Tolerances: f32
  forward within 1e-5 of the logits' scale; bf16 within 5e-2
  (tests/test_torch_lm.py's); f32 decode within 1e-3 of scale, that
  file's decode bound: both paths keep the cache's k / v in bf16, and a
  last-bit difference of an f32 key (a psum's order) can round to the
  neighbouring bf16 value.
* arctic-smoke's MoE block on a 2x2 world at B = 4: T = 128 takes the a2a
  path and T = 16 the local path, held in f32 within 1e-5 of scale against
  the reference's own ``moe_block`` on a 2x2 ``jax.sharding.Mesh`` (a
  subprocess with 4 forced host devices, started beside the world), and
  the local path against the port's plain path on the same data block.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
from _lm_worlds import start_lm_world, wait_world  # noqa: E402

from repro_torch import configs  # noqa: E402

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
F32_SCALE_TOL = 1e-5
BF16_TOL = 5e-2
F32_DECODE_SCALE_TOL = 1e-3

REF_MOE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.models import moe as MOE
from repro.models.sharding import MeshAxes, set_activation_axes

data = np.load(sys.argv[1])
cfg = dataclasses.replace(configs.get_smoke("arctic_480b"), dtype="float32")
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
set_activation_axes(MeshAxes(sizes={"data": 2, "model": 2}), mesh)
p = {k[2:]: jnp.asarray(data[k]) for k in data.files if k.startswith("p/")}
out = {}
for t in (128, 16):
    x = jnp.asarray(data[f"x{t}"])
    with mesh:
        out[f"y{t}"] = np.asarray(jax.jit(
            lambda p, x: MOE.moe_block(p, x, cfg))(p, x))
np.savez(sys.argv[2], **out)
"""


def _lm_cases():
    cases = []
    for arch in configs.ARCH_IDS:
        for dt in ("float32", "bfloat16"):
            cases.append(dict(kind="lm", arch=arch, name=f"{arch}/{dt}",
                              replace=dict(dtype=dt), batch=4, seq=16,
                              gen=2))
    return cases


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_forward_and_decode_on_2x2_and_1x4_worlds(tmp_path):
    cases = _lm_cases()
    worlds = {s: start_lm_world(tmp_path / s, shape, cases)
              for s, shape in (("2x2", (2, 2)), ("1x4", (1, 4)))}
    for s, handle in worlds.items():
        ranks, infos = wait_world(handle)
        for c in cases:
            n, f32 = c["name"], c["replace"]["dtype"] == "float32"
            for r, o in enumerate(ranks):
                where = f"{s} rank {r} {n}"
                err = _rel(o[n + "/fwd_got"], o[n + "/fwd_want"])
                assert err <= (F32_SCALE_TOL if f32 else BF16_TOL), \
                    (where, "forward", err)
                if n + "/dec_got" not in o:
                    continue
                err = _rel(o[n + "/dec_got"], o[n + "/dec_want"])
                assert err <= (F32_DECODE_SCALE_TOL if f32 else BF16_TOL), \
                    (where, "decode", err)
                np.testing.assert_array_equal(o[n + "/tok_got"],
                                              o[n + "/tok_want"],
                                              err_msg=where)
            # the sharded code ran: every rank issued tagged collectives
            assert any(k.startswith("all_reduce/") for k in infos[0][n]), n
        if s == "1x4":     # heads / vocab / d_ff on a 4-way model axis
            tags = {k for i in infos[0].values() for k in i}
            assert {"all_reduce/attn", "all_gather_into_tensor/seq",
                    "all_reduce/rglru", "all_gather_into_tensor/gather",
                    "all_gather_into_tensor/logits",
                    "all_reduce/moe"} <= tags, tags


def test_moe_mesh_paths_against_reference_2x2(tmp_path):
    cfg = configs.get_smoke("arctic_480b")
    rng = np.random.default_rng(5)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    fr = cfg.moe_dense_ff or f
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d), "res_w_gate": (d, fr),
              "res_w_up": (d, fr), "res_w_down": (fr, d)}
    arrays = {f"p/{k}": (rng.normal(size=s) / np.sqrt(s[-2])).astype(
        np.float32) for k, s in shapes.items()}
    for t in (128, 16):
        arrays[f"x{t}"] = rng.normal(size=(4, t, d)).astype(np.float32)
    inputs = tmp_path / "moe_in.npz"
    np.savez(inputs, **arrays)
    cases = []
    for t in (128, 16):
        part = tmp_path / f"moe_x{t}.npz"
        np.savez(part, x=arrays[f"x{t}"], **{k: v for k, v in arrays.items()
                                              if k.startswith("p/")})
        cases.append(dict(kind="moe", arch="arctic_480b", name=f"t{t}",
                          replace=dict(dtype="float32"), data=str(part)))
    world = start_lm_world(tmp_path / "world", (2, 2), cases)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-c", REF_MOE, str(inputs),
                          str(tmp_path / "moe_ref.npz")], env=env,
                         capture_output=True, text=True, timeout=300)
    ranks, infos = wait_world(world)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    want = np.load(tmp_path / "moe_ref.npz")
    for t, path in ((128, "all_to_all_single/moe"),
                    (16, "all_reduce/moe")):
        n = f"t{t}"
        assert path in infos[0][n], (n, infos[0][n])
        if t == 128:       # the a2a path's two all-to-alls and its gather
            assert infos[0][n][path][0] == 2
            assert "all_gather_into_tensor/moe" in infos[0][n]
        else:
            assert "all_to_all_single/moe" not in infos[0][n]
        for r, o in enumerate(ranks):
            rows = slice(2 * (r // 2), 2 * (r // 2) + 2)   # data index r // 2
            err = _rel(o[n + "/got"], want[f"y{t}"][rows])
            assert err <= F32_SCALE_TOL, (n, r, err)
            if t == 16:    # the local path is the plain path's function
                err = _rel(o[n + "/got"], o[n + "/plain"])
                assert err <= F32_SCALE_TOL, (n, r, "plain", err)
