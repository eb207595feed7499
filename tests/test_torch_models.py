"""Port parity for the LM stack's modules (repro_torch.models) on the CPU.

Each function is held against its reference counterpart on the same
numpy inputs (made from a seed) and the same weights (the reference's own
initialisers, carried across as numpy).  Tolerances: rtol = atol = 1e-5 in
f32 where the algorithm is the same; 1e-4 for the scans (the reference's
associative scans against the port's sequential loops: the reference's
own oracle tolerance in tests/test_recurrences.py); masks and MoE token
picks exact.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import rglru as JRG
from repro.models import xlstm as JXL
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import sharding as SH
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ModelConfig

TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def N(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def both(tree):
    """A reference parameter dict as (jax dict, torch dict)."""
    host = {k: np.asarray(v) for k, v in tree.items()}
    return ({k: J(v) for k, v in host.items()},
            {k: T(v) for k, v in host.items()})


def cfgs(**kw):
    return JModelConfig(name="t", **kw), ModelConfig(name="t", **kw)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(N(a), N(b), **tol)


# -- norms, embeddings, rope, masks, attention --------------------------------


def test_rmsnorm_rope_unembed():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    scale = rng.normal(size=(8,)).astype(np.float32)
    close(JL.rmsnorm(J(x), J(scale)), L.rmsnorm(T(x), T(scale)))
    pos = rng.integers(0, 40, size=(2, 5)).astype(np.int32)
    close(JL.rope(J(x), J(pos), 500.0), L.rope(T(x), T(pos), 500.0))
    h = rng.normal(size=(2, 5, 8)).astype(np.float32)
    table = rng.normal(size=(11, 8)).astype(np.float32)
    for cap in (0.0, 2.5):
        close(JL.unembed(J(h), J(table), cap), L.unembed(T(h), T(table), cap))


@pytest.mark.parametrize("causal,local,prefix", [
    (True, 0, 0), (False, 0, 0), (True, 3, 0), (True, 0, 4), (True, 3, 4)])
def test_attention_mask_exact(causal, local, prefix):
    rng = np.random.default_rng(1)
    q = rng.integers(0, 12, size=(2, 6)).astype(np.int32)
    k = rng.integers(-1, 12, size=(2, 9)).astype(np.int32)
    kw = dict(causal=causal, local_window=local, n_prefix=prefix)
    np.testing.assert_array_equal(
        np.asarray(JL.attention_mask(J(q), J(k), **kw)),
        L.attention_mask(T(q), T(k), **kw).numpy())


def test_gqa_attention():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 7, 2, 8)).astype(np.float32) for _ in range(2))
    mask = rng.random((2, 5, 7)) < 0.6
    mask[:, :, 0] = True
    close(JL.gqa_attention(J(q), J(k), J(v), J(mask)),
          L.gqa_attention(T(q), T(k), T(v), T(mask)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_block(act):
    jp, tp = both(JL.init_ffn(jax.random.key(3), 16, 24, jnp.float32))
    x = np.random.default_rng(3).normal(size=(2, 5, 16)).astype(np.float32)
    close(JL.ffn_block(jp, J(x), act), L.ffn_block(tp, T(x), act))


@pytest.mark.parametrize("bias,local", [(False, 0), (True, 0), (False, 4)])
def test_attn_block_full_sequence_and_with_cache(bias, local):
    jc, tc = cfgs(n_layers=1, d_model=32, n_heads=4, n_kv=2, d_ff=0, vocab=8,
                  qkv_bias=bias, local_window=local)
    jp, tp = both(JL.init_attn(jax.random.key(4), jc, jnp.float32))
    if bias:                          # non-zero biases exercise the add
        rng = np.random.default_rng(40)
        for name in ("bq", "bk", "bv"):
            b = rng.normal(size=tp[name].shape).astype(np.float32)
            jp[name], tp[name] = J(b), T(b)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    jo, jn = JL.attn_block(jp, J(x), J(pos), jc)
    to, tn = L.attn_block(tp, T(x), T(pos), tc)
    assert jn is None and tn is None
    close(jo, to)
    # with a cache: 3 new tokens written at index 5 of a 10-slot cache
    ck = rng.normal(size=(2, 10, 2, 8)).astype(np.float32)
    cv = rng.normal(size=(2, 10, 2, 8)).astype(np.float32)
    xs = x[:, :3]
    pos = np.broadcast_to(np.arange(5, 8, dtype=np.int32), (2, 3))
    jo, (jk, jv) = JL.attn_block(jp, J(xs), J(pos), jc,
                                 kv_cache=(J(ck).astype(jnp.bfloat16),
                                           J(cv).astype(jnp.bfloat16)),
                                 cache_index=jnp.int32(5))
    tk_in = T(ck).to(torch.bfloat16)
    to, (tk, tv) = L.attn_block(tp, T(xs), T(pos), tc,
                                kv_cache=(tk_in, T(cv).to(torch.bfloat16)),
                                cache_index=torch.tensor(5, dtype=torch.int32))
    close(jo, to)
    close(jk, tk)
    close(jv, tv)
    assert torch.equal(tk_in, T(ck).to(torch.bfloat16))   # input untouched


# -- RG-LRU -------------------------------------------------------------------


def _rglru_params(d=16, seed=5):
    jc, tc = cfgs(n_layers=1, d_model=d, n_heads=2, n_kv=2, d_ff=0, vocab=8,
                  pattern=("rglru",))
    return jc, tc, both(JRG.init_rglru(jax.random.key(seed), jc, jnp.float32))


def test_rglru_with_and_without_h0():
    _, _, (jp, tp) = _rglru_params()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 10, 16)).astype(np.float32)
    h0 = rng.normal(size=(2, 16)).astype(np.float32)
    for args_j, args_t in (((), ()), ((J(h0),), (T(h0),))):
        jy, jh = JRG.rglru(jp, J(x), *args_j)
        ty, th = RG.rglru(tp, T(x), *args_t)
        close(jy, ty, SCAN_TOL)
        close(jh, th, SCAN_TOL)


def test_rglru_block_forward_then_decode():
    jc, tc, (jp, tp) = _rglru_params(seed=6)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    jo, jst = JRG.rglru_block(jp, J(x[:, :6]), None, jc)
    to, tst = RG.rglru_block(tp, T(x[:, :6]), None, tc)
    close(jo, to, SCAN_TOL)
    for a, b in zip(jst, tst):
        close(a, b, SCAN_TOL)
    carried = tuple(T(N(a)) for a in jst)
    jo, jst = JRG.rglru_block(jp, J(x[:, 6:]), None, jc, state=jst)
    to, tst = RG.rglru_block(tp, T(x[:, 6:]), None, tc, state=carried)
    close(jo, to)
    for a, b in zip(jst, tst):
        close(a, b)


# -- xLSTM ---------------------------------------------------------------------


def _mlstm_inputs(rng, b, h, t, hd):
    q, k, v = (rng.normal(size=(b, h, t, hd)).astype(np.float32)
               for _ in range(3))
    log_f = np.log(rng.uniform(0.5, 0.99, size=(b, h, t))).astype(np.float32)
    ig = rng.uniform(0.1, 1.0, size=(b, h, t)).astype(np.float32)
    return q, k, v, log_f, ig


@pytest.mark.parametrize("t,chunk", [(16, 4), (17, 4), (8, 8), (23, 16)])
def test_mlstm_chunk_scan(t, chunk):
    ins = _mlstm_inputs(np.random.default_rng(0), 2, 3, t, 4)
    jy, (jc, jn) = JXL._mlstm_chunk_scan(*map(J, ins), chunk=chunk)
    ty, (tc, tn) = XL._mlstm_chunk_scan(*map(T, ins), chunk=chunk)
    close(jy, ty, SCAN_TOL)
    close(jc, tc, SCAN_TOL)
    close(jn, tn, SCAN_TOL)


def test_mlstm_decode_step():
    rng = np.random.default_rng(7)
    ins = _mlstm_inputs(rng, 2, 3, 1, 4)
    c = rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
    n = rng.normal(size=(2, 3, 4)).astype(np.float32)
    jy, (jc, jn) = JXL.mlstm_decode_step(*map(J, ins), (J(c), J(n)))
    ty, (tc, tn) = XL.mlstm_decode_step(*map(T, ins), (T(c), T(n)))
    for a, b in ((jy, ty), (jc, tc), (jn, tn)):
        close(a, b)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_forward_then_decode(kind):
    jc, tc = cfgs(n_layers=1, d_model=16, n_heads=2, n_kv=2, d_ff=0, vocab=8,
                  pattern=(kind,))
    init = JXL.init_mlstm if kind == "mlstm" else JXL.init_slstm
    jfn = JXL.mlstm_block if kind == "mlstm" else JXL.slstm_block
    tfn = XL.mlstm_block if kind == "mlstm" else XL.slstm_block
    jp, tp = both(init(jax.random.key(8), jc, jnp.float32))
    x = np.random.default_rng(8).normal(size=(2, 9, 16)).astype(np.float32)
    jo, jst = jfn(jp, J(x[:, :8]), None, jc)
    to, tst = tfn(tp, T(x[:, :8]), None, tc)
    close(jo, to, SCAN_TOL)
    for a, b in zip(jst, tst):
        close(a, b, SCAN_TOL)
    carried = tuple(T(N(a)) for a in jst)
    jo, jst = jfn(jp, J(x[:, 8:]), None, jc, state=jst)
    to, tst = tfn(tp, T(x[:, 8:]), None, tc, state=carried)
    close(jo, to)
    for a, b in zip(jst, tst):
        close(a, b)


# -- MoE -----------------------------------------------------------------------


def _route_case(tie):
    rng = np.random.default_rng(9)
    n, d = 24, 16
    if tie:   # 3 distinct rows repeated: every expert's tokens tie in groups
        xf = rng.normal(size=(3, d)).astype(np.float32)[np.arange(n) % 3]
    else:
        xf = rng.normal(size=(n, d)).astype(np.float32)
    router = rng.normal(size=(d, 4)).astype(np.float32)
    return xf, router


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("k,cap", [(1, 5), (2, 8), (2, 13)])
def test_route_and_gather_exact(tie, k, cap):
    xf, router = _route_case(tie)
    jw, ji = JMOE._route_and_gather(J(xf), J(router), 4, k, cap)
    tw, ti = MOE._route_and_gather(T(xf), T(router), 4, k, cap)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    close(jw, tw)
    if tie:    # some expert's capacity cuts a group of tied tokens
        nxt = np.asarray(JMOE._route_and_gather(J(xf), J(router), 4, k,
                                                cap + 1)[0])
        assert any(nxt[e, cap] == nxt[e, cap - 1] for e in range(4))


@pytest.mark.parametrize("arch", ["arctic_480b", "llama4_maverick_400b_a17b"])
def test_moe_block_plain_path(arch):
    """arctic: top-2 with the dense residual; llama4: top-1 without."""
    jc = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    tc = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    jp, tp = both(JMOE.init_moe(jax.random.key(10), jc, jnp.float32))
    x = np.random.default_rng(10).normal(size=(2, 8, jc.d_model)).astype(
        np.float32)
    want = JMOE._moe_block_jnp(jp, J(x), jc)
    close(want, MOE._moe_block_plain(tp, T(x), tc))
    close(want, MOE.moe_block(tp, T(x), tc))


def test_moe_block_under_meshes():
    """Under any mesh, 1x1 included, moe_block takes a mesh path: on a 1x1
    mesh it equals the plain path bit for bit (its collectives have size
    1); on a recorded 2-way model axis it issues the local path's psum
    (tag "moe") and the dense residual's (tag "ffn"); under no mesh it is
    the plain path."""
    from repro_torch.core.collectives import RecordingCollectives
    tc = configs.get_smoke("arctic_480b")
    _, tp = both(JMOE.init_moe(jax.random.key(11), tc, jnp.float32))
    x = T(np.random.default_rng(11).normal(size=(2, 4, tc.d_model)).astype(
        np.float32))
    plain = MOE._moe_block_plain(tp, x, tc)
    try:
        for sizes in ((("data", 1), ("model", 1)), (("data", 1), ("model", 2)),
                      (("data", 2), ("model", 1))):
            comm = RecordingCollectives(sizes)
            axes = SH.MeshAxes(sizes=dict(sizes))
            SH.set_activation_axes(axes, mesh=comm.mesh, comm=comm)
            specs = SH.param_specs(tc, {n: v.shape for n, v in tp.items()},
                                   axes)
            blocks = {n: SH.local_block(v, specs[n], *SH.mesh_coords(comm))
                      for n, v in tp.items()}      # rank 0's experts
            out = MOE.moe_block(blocks, x, tc)
            assert [(c.op, c.tag) for c in comm.log] == [
                ("all_reduce", "moe"), ("all_reduce", "ffn")]
            if dict(sizes)["model"] == 1:
                assert torch.equal(out, plain)
            assert SH.constrain_act(x, "btd") is x
    finally:
        SH.set_activation_axes(None, None)
    assert torch.equal(MOE.moe_block(tp, x, tc), plain)
    assert SH.constrain_act(x, "btd") is x


def test_meshes_without_a_process_group():
    assert launch_mesh.make_smoke_mesh() is None
    assert launch_mesh.mesh_axes(None) is None
    with pytest.raises(RuntimeError, match="256 ranks"):
        launch_mesh.make_production_mesh()


# -- init statistics -----------------------------------------------------------


def _leaves_by_name(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            for name, arrs in _leaves_by_name(v, k).items():
                out.setdefault(name, []).extend(arrs)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            for name, arrs in _leaves_by_name(v, prefix).items():
                out.setdefault(name, []).extend(arrs)
    else:
        out[prefix] = [np.asarray(tree, np.float64).ravel()]
    return out


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_125m",
                                  "arctic_480b", "hubert_xlarge"])
def test_init_statistics_match_the_reference(arch):
    """The smoke config at d_model 512 (so that every pooled leaf has
    thousands of draws): each weight's std, pooled over layers by name,
    within 5 % of the reference's, zeros where the reference has zeros,
    and every lam's implied u = a^(2c) within [0.9**2, 0.999**2]."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), d_model=512)
    tcfg = dataclasses.replace(configs.get_smoke(arch), d_model=512)
    ref = _leaves_by_name(jax.tree.map(np.asarray,
                                       JM.init_params(jax.random.key(0), jcfg)))
    model = M.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    port = {}
    for name, prm in model.named_parameters():
        port.setdefault(name.rsplit(".", 1)[-1], []).append(
            prm.detach().double().numpy().ravel())
    assert sorted(port) == sorted(ref)
    for name in ref:
        r, p = np.concatenate(ref[name]), np.concatenate(port[name])
        assert r.size == p.size, name
        if name == "lam":
            u = np.exp(-2 * 8.0 * np.log1p(np.exp(p)))
            assert (u >= 0.9 ** 2 - 1e-6).all() and (u <= 0.999 ** 2 + 1e-6).all()
            continue
        if r.std() == 0:
            assert p.std() == 0 and (p == r[0]).all(), name
            continue
        assert abs(p.std() / r.std() - 1) < 0.05, (name, p.std(), r.std())
        assert abs(p.mean()) < 0.05 * r.std() + 1e-3, name
