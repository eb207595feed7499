"""The LM stack at depth, on the CPU: what bf16 does to 26-32 layers, in the
reference and in the port alike.

tests/test_torch_lm.py holds the smoke configs (2-8 layers) to 5e-2 at
bf16.  At the full depth of smollm-360m (32 layers) and recurrentgemma-2b
(26), with widths cut for the CPU, the reference's own decode leaves its
own teacher-forced forward by more than 5e-2 in bf16 (its decode keeps k
and v in bf16, its forward does not, and the residual stream rounds to
bf16 every layer), while with f32 activations both paths agree within
5e-2.  So:

  * with f32 activations: decode against forward within rtol = atol =
    5e-2 in both packages, and the port's forward within 1e-4 of the
    reference's;
  * in bf16: the port's forward is held to the reference's within the
    reference's own decode-against-forward gap, and the port's decode
    against its forward to 1.25x the reference's (the two packages round
    to bf16 at other points: XLA keeps some products in f32 under jit).

Run with ``-s`` to print the numbers.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs
from repro_torch.models import model as M

TOL = 5e-2
CASES = {
    # depth and head geometry as published; widths (and recurrentgemma's
    # vocab) cut so that the CPU holds both packages' models
    "smollm_360m": dict(d_model=480, d_ff=1280),
    "recurrentgemma_2b": dict(d_model=640, d_ff=1920, vocab=32_000),
}


def _gap(want, got):
    err = np.abs(got - want)
    return float(err.max()), int((err > TOL + TOL * np.abs(want)).sum())


def _run(arch, dtype, b=2, t=12):
    jc = dataclasses.replace(jconfigs.get(arch), dtype=dtype, **CASES[arch])
    tc = dataclasses.replace(configs.get(arch), dtype=dtype, **CASES[arch])
    params = jax.jit(lambda k: JM.init_params(k, jc))(jax.random.key(0))
    model = M.params_from_numpy(jax.tree.map(np.asarray, params), tc, "cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab, (b, t)).astype(
        np.int32)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    ref_full = f32(jax.jit(lambda p, x: JM.forward(p, jc, {"tokens": x}))(
        params, jnp.asarray(toks)))
    step = jax.jit(lambda p, x, c: JM.decode_step(p, jc, x, c))
    cache, outs = JM.init_cache(jc, b, t + 1), []
    for s in range(t):
        lg, cache = step(params, jnp.asarray(toks[:, s:s + 1]), cache)
        outs.append(f32(lg))
    ref_dec = np.concatenate(outs, axis=1)
    with torch.no_grad():
        full = M.forward(model, {"tokens": torch.from_numpy(toks)}).float()
    cache, outs = M.init_cache(tc, b, t + 1, "cpu"), []
    for s in range(t):
        lg, cache = M.decode_step(model, torch.from_numpy(toks[:, s:s + 1]),
                                  cache)
        outs.append(lg.float())
    dec = torch.cat(outs, dim=1).numpy()
    full = full.numpy()
    res = dict(ref_decode_vs_forward=_gap(ref_full, ref_dec),
               port_decode_vs_forward=_gap(full, dec),
               port_vs_ref_forward=_gap(ref_full, full),
               port_vs_ref_decode=_gap(ref_dec, dec))
    print(arch, dtype, res)
    return res


@pytest.mark.parametrize("arch", list(CASES))
def test_decode_against_forward_at_depth(arch):
    r32 = _run(arch, "float32")
    assert r32["ref_decode_vs_forward"][1] == 0
    assert r32["port_decode_vs_forward"][1] == 0
    assert r32["port_vs_ref_forward"][0] < 1e-4
    r16 = _run(arch, "bfloat16")
    ref_gap = r16["ref_decode_vs_forward"][0]
    assert r16["port_vs_ref_forward"][0] <= ref_gap
    assert r16["port_decode_vs_forward"][0] <= 1.25 * ref_gap
