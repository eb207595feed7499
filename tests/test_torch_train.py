"""Port parity for LM training on the CPU: ``repro_torch.train`` (the
hand-written AdamW, global-norm clipping, the loss and the train step),
remat in ``models.model.forward``, against ``repro.train`` on the same
numpy inputs and the same weights (the reference's initial train state,
carried across with ``train_state_from_numpy``).

Tolerances:
- the optimizer alone: rtol 1e-6 (f32 moments and parameters); bf16
  moments and bf16 gradients within one bf16 ulp (rtol 2**-7);
- one train step with f32 activations: loss and grad norm rtol 1e-5,
  every gradient leaf atol 1e-5, new parameters atol 1e-5 wherever the
  step is well conditioned (below); at the configs' bf16, rtol = atol =
  5e-2 throughout;
- remat on against off, and the streamed CE against the plain one: bit
  for bit / 1e-6.

Why "well conditioned": at step 1 AdamW moves a parameter by lr * (u +
wd * p) with u = g / (|g| + eps), eps = 1e-8.  The slope of u in g is
eps / (|g| + eps)**2, 1e8 at g = 0, so a gradient that sits at its own
rounding noise (|g| ~ 1e-9; the two packages' gradients differ by up to
6e-7) can move its parameter by up to 2 * lr in one package and not in the
other.  Where |u| >= 0.99 in the reference's own step, |g| >= 99 eps,
the slope is at most 10 and a 1e-6 gradient difference moves the
parameter by at most 1e-5: there the new parameters are held to 1e-5.
Everywhere else they are held to the 2 * lr that bounds any such pair.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.train import make_train_step, optimizer as O, train_step as T

CPU = "cpu"
LR = 1e-3
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
BF16_ULP = dict(rtol=2 ** -7, atol=0.0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaves(tree):
    return [_np(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def ref():
    """arch -> the reference's initial train state (jax), built once
    (jitted: the same bits as eager, in about half the time)."""
    built = {}
    init = jax.jit(jinit_train_state, static_argnums=1)

    def get(arch):
        if arch not in built:
            built[arch] = init(jax.random.key(0), jconfigs.get_smoke(arch))
        return built[arch]
    return get


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_smoke(arch), **kw),
            dataclasses.replace(configs.get_smoke(arch), **kw))


def _port_state(jstate, cfg):
    return M.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate._asdict()), cfg, CPU)


def _batch(cfg, b=2, t=16, seed=1):
    """Numpy inputs from a seed: tokens (or frames), labels, patches."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio_frames":
        out["frames"] = rng.normal(size=(b, t, cfg.frontend_dim)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, size=(b, t)).astype(
            np.int32)
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.normal(
            size=(b, cfg.n_prefix, cfg.frontend_dim)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab, size=(b, t)).astype(np.int32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _assert_new_params(p0, p_ref, p_port, tol, lr=LR, wd=0.1):
    """One AdamW step's new parameters (module docstring): ``tol`` where
    the reference's Adam direction |u| >= 0.99, 2 * lr + atol elsewhere."""
    for a, r, q in zip(p0, p_ref, p_port):
        u = (a - r) / lr - wd * a
        well = np.abs(u) >= 0.99
        np.testing.assert_allclose(q[well], r[well], **tol)
        assert np.abs(q - r).max() <= 2 * lr + tol["atol"]


# -- the optimizer alone ------------------------------------------------------

def _opt_inputs(seed, opt_dtype, grad_dtype):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (33,), "c": (2, 3, 4)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (rng.uniform(size=s) * 0.01).astype(np.float32)
         for k, s in shapes.items()}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jax_in = dict(
        grads={k: jnp.asarray(x, jdt[grad_dtype]) for k, x in g.items()},
        opt={"m": {k: jnp.asarray(x, jdt[opt_dtype]) for k, x in m.items()},
             "v": {k: jnp.asarray(x, jdt[opt_dtype]) for k, x in v.items()},
             "step": jnp.int32(3)},
        params={k: jnp.asarray(x) for k, x in p.items()})
    torch_in = dict(
        grads={k: torch.from_numpy(x).to(tdt[grad_dtype])
               for k, x in g.items()},
        opt={"m": {k: torch.from_numpy(x).to(tdt[opt_dtype])
                   for k, x in m.items()},
             "v": {k: torch.from_numpy(x).to(tdt[opt_dtype])
                   for k, x in v.items()},
             "step": torch.tensor(3, dtype=torch.int32)},
        params={k: torch.from_numpy(x.copy()) for k, x in p.items()})
    return jax_in, torch_in


@pytest.mark.parametrize("opt_dtype,grad_dtype", [("float32", "float32"),
                                                  ("bfloat16", "bfloat16")])
def test_adamw_update_matches_the_reference(opt_dtype, grad_dtype):
    j, t = _opt_inputs(0, opt_dtype, grad_dtype)
    jp, jopt = JO.adamw_update(j["grads"], j["opt"], j["params"], lr=LR)
    tp, topt = O.adamw_update(t["grads"], t["opt"], t["params"], lr=LR)
    assert int(topt["step"]) == int(jopt["step"]) == 4
    assert topt["step"].dtype == torch.int32
    mom_tol = BF16_ULP if opt_dtype == "bfloat16" else dict(rtol=1e-6, atol=0)
    for k in jp:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-6, atol=0)
        assert topt["m"][k].dtype == t["opt"]["v"][k].dtype
        for mom in ("m", "v"):
            np.testing.assert_allclose(_np(topt[mom][k]), _np(jopt[mom][k]),
                                       **mom_tol)


@pytest.mark.parametrize("max_norm", [0.05, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_the_reference(max_norm, dtype):
    j, t = _opt_inputs(1, "float32", dtype)
    jg, jn = JO.clip_by_global_norm(j["grads"], max_norm)
    tg, tn = O.clip_by_global_norm(t["grads"], max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(O.global_norm(t["grads"])), float(jn),
                               rtol=1e-6)
    for k in jg:
        assert tg[k].dtype == t["grads"][k].dtype
        np.testing.assert_allclose(
            _np(tg[k]), _np(jg[k]),
            **(BF16_ULP if dtype == "bfloat16" else dict(rtol=1e-6, atol=0)))


def test_adamw_init_layout_and_dtypes():
    model = M.init_params(configs.get_smoke("smollm_360m"),
                          torch.Generator().manual_seed(0), CPU)
    opt = O.adamw_init(dict(model.named_parameters()), torch.bfloat16)
    names = [n for n, _ in model.named_parameters()]
    assert list(opt["m"]) == list(opt["v"]) == names
    assert all(m.dtype == torch.bfloat16 and not m.any()
               for m in opt["m"].values())
    assert opt["step"].shape == () and opt["step"].dtype == torch.int32


# -- one step of every smoke arch ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_one_train_step_matches_the_reference(ref, arch, dtype):
    """The reference's step for microbatch 0 and f32 gradients, as its
    ``make_train_step`` composes it: ``value_and_grad(loss_fn)``, then
    ``clip_by_global_norm``, then ``adamw_update`` (each jitted), against
    the port's ``make_train_step`` from the same weights."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jstate = ref(arch)
    state = _port_state(jstate, tcfg)
    p0 = _leaves(jstate.params)
    jb, tb = _both(_batch(jcfg))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b)))(jstate.params, jb)

    def jupdate(grads, opt, params):
        grads, norm = JO.clip_by_global_norm(grads, 1.0)
        return JO.adamw_update(grads, opt, params, lr=LR)[0], norm

    jparams, jnorm = jax.jit(jupdate)(jgrads, jstate.opt, jstate.params)

    tloss, tgrads = T.loss_and_grads(state.model, tb)
    state, metrics = make_train_step(tcfg, lr=LR)(state, tb)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=tol["rtol"])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol["rtol"])
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jnorm),
                               rtol=tol["rtol"])
    port_grads = M._reference_layout(state.model, lambda n: _np(tgrads[n]))
    for a, b in zip(_leaves(port_grads), _leaves(jgrads)):
        np.testing.assert_allclose(a, b, **tol)
    new = M.params_to_numpy(state.model)
    assert (jax.tree.structure(new)
            == jax.tree.structure(jax.tree.map(np.asarray, jparams)))
    _assert_new_params(p0, _leaves(jparams), _leaves(new), tol)
    assert int(state.opt["step"]) == 1
    assert not np.array_equal(_leaves(new)[0], p0[0])


def test_microbatched_step_matches_the_reference_and_the_full_step(ref):
    """gemma's smoke config, batch 4 in two microbatches: the reference's
    own microbatched step (f32 activations), and within 2e-3 of the port's
    full step (tests/test_archs.py's bound, at the config's bf16)."""
    jstate = ref("gemma_7b")
    jcfg, tcfg = _cfgs("gemma_7b", dtype="float32")
    p0 = _leaves(jstate.params)
    jb, tb = _both(_batch(jcfg, b=4))
    jnew, jm = jax.jit(jmake_train_step(jcfg, lr=LR, microbatch=2))(jstate, jb)
    state, m = make_train_step(tcfg, lr=LR, microbatch=2)(
        _port_state(jstate, tcfg), tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    _assert_new_params(p0, _leaves(jnew.params),
                       _leaves(M.params_to_numpy(state.model)), F32_TOL)
    for k in ("m", "v"):
        for a, b in zip(_leaves(M._reference_layout(
                state.model, lambda n, k=k: _np(state.opt[k][n]))),
                _leaves(jnew.opt[k])):
            np.testing.assert_allclose(a, b, **F32_TOL)

    _, bcfg = _cfgs("gemma_7b")
    _, full = make_train_step(bcfg, lr=LR)(_port_state(jstate, bcfg), tb)
    _, micro = make_train_step(bcfg, lr=LR, microbatch=2)(
        _port_state(jstate, bcfg), tb)
    assert abs(float(full["loss"]) - float(micro["loss"])) < 2e-3


def test_bf16_moments_and_gradients_match_the_reference(ref):
    """arctic's smoke config with ``opt_dtype="bfloat16"``: gradients cast
    to bf16 (the default that follows from it), moments kept in bf16, one
    step against the reference's."""
    jcfg, tcfg = _cfgs("arctic_480b", opt_dtype="bfloat16")
    jstate = jinit_train_state(jax.random.key(0), jcfg)
    state = _port_state(jstate, tcfg)
    assert all(m.dtype == torch.bfloat16 for m in state.opt["m"].values())
    jb, tb = _both(_batch(jcfg))
    jnew, jm = jax.jit(jmake_train_step(jcfg, lr=LR))(jstate, jb)
    state, m = make_train_step(tcfg, lr=LR)(state, tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=BF16_TOL["rtol"])
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=BF16_TOL["rtol"])
    assert all(v.dtype == torch.bfloat16 for v in state.opt["v"].values())
    for k in ("m", "v"):
        for a, b in zip(_leaves(M._reference_layout(
                state.model, lambda n, k=k: _np(state.opt[k][n]))),
                _leaves(jnew.opt[k])):
            np.testing.assert_allclose(a, b, **BF16_TOL)
    for a, b in zip(_leaves(M.params_to_numpy(state.model)),
                    _leaves(jnew.params)):
        np.testing.assert_allclose(a, b, **BF16_TOL)


# -- remat and the streamed CE --------------------------------------------------

@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b",
                                  "xlstm_125m", "arctic_480b"])
def test_remat_changes_no_gradient(arch, policy, monkeypatch):
    """Remat on against off: loss and every gradient bit for bit.  With
    remat each pattern group's layers run twice (forward, then recomputed
    in the backward) and the remainder layers once; under ``"dots"`` the
    weight products are saved."""
    base = dataclasses.replace(configs.get_smoke(arch), remat=False)
    _, tb = _both(_batch(base))
    calls, saved = [], []
    layer_forward = M.Layer.forward
    policy_fn = M._save_weight_products

    def counted(self, *a, **kw):
        calls.append(self)
        return layer_forward(self, *a, **kw)

    def seen(ctx, op, *a, **kw):
        out = policy_fn(ctx, op, *a, **kw)
        saved.append(out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE)
        return out

    monkeypatch.setattr(M.Layer, "forward", counted)
    monkeypatch.setattr(M, "_save_weight_products", seen)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        model = M.init_params(cfg, torch.Generator().manual_seed(0), CPU)
        calls.clear()
        out[remat] = T.loss_and_grads(model, tb)
        grouped = cfg.n_groups * len(cfg.pattern)
        assert len(calls) == cfg.n_layers + (grouped if remat else 0)
    assert torch.equal(out[True][0], out[False][0])
    for n, g in out[False][1].items():
        assert torch.equal(out[True][1][n], g), n
    assert any(saved) == (policy == "dots")


@pytest.mark.parametrize("arch", ["paligemma_3b", "hubert_xlarge",
                                  "smollm_360m"])
def test_streamed_loss_and_mask_match_the_reference(ref, arch):
    """loss_chunk below T (4: four chunks; 5: the divisor search gives 3,
    then 2) with and without a loss mask, f32 activations: within 1e-6 of
    the unchunked loss and rtol 1e-5 of the reference's chunked loss, the
    vision prefix sliced off and hubert's untied head used."""
    jcfg, tcfg = _cfgs(arch, dtype="float32")
    jstate = ref(arch)
    model = _port_state(jstate, tcfg).model
    batch = _batch(jcfg)
    batch["loss_mask"] = (np.random.default_rng(5).uniform(size=(2, 16))
                          < 0.7).astype(np.float32)
    for with_mask in (False, True):
        b = dict(batch) if with_mask else {k: v for k, v in batch.items()
                                           if k != "loss_mask"}
        jb, tb = _both(b)
        with torch.no_grad():
            plain = float(T.loss_fn(model, tb))
            for chunk in (4, 5):
                got = float(T.loss_fn(model, tb, loss_chunk=chunk))
                want = JT.loss_fn(jstate.params, jcfg, jb, loss_chunk=chunk)
                assert abs(got - plain) <= 1e-6
                np.testing.assert_allclose(got, float(want), rtol=1e-5)


def test_streamed_loss_gradients_equal_the_plain_ones():
    """The chunks run under checkpoint: with f32 activations, the same
    gradients as one unembed within 1e-6 (in bf16 the tied table's
    gradient is a sum of per-chunk bf16 products, in either package)."""
    cfg = dataclasses.replace(configs.get_smoke("smollm_360m"),
                              dtype="float32")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    _, tb = _both(_batch(cfg))
    la, ga = T.loss_and_grads(model, tb)
    lb, gb = T.loss_and_grads(model, tb, loss_chunk=4)
    assert abs(float(la) - float(lb)) <= 1e-6
    for n in ga:
        np.testing.assert_allclose(gb[n].numpy(), ga[n].numpy(), rtol=0,
                                   atol=1e-6)


def test_train_loss_decreases_smollm():
    """tests/test_archs.py's learning check: 8 steps on one fixed batch
    (b=4, t=32, lr 3e-3) lower the loss by more than 0.5."""
    cfg = configs.get_smoke("smollm_360m")
    state = T.init_train_state(cfg, torch.Generator().manual_seed(0), CPU)
    _, tb = _both(_batch(cfg, b=4, t=32))
    step = make_train_step(cfg, lr=3e-3)
    losses = []
    for _ in range(8):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses
    assert int(state.opt["step"]) == 8


def test_train_state_numpy_round_trip(ref):
    """train_state_to_numpy is the reference's TrainState._asdict() layout:
    the same tree structure, shapes and dtypes, and it inverts
    train_state_from_numpy bit for bit."""
    jstate = ref("recurrentgemma_2b")
    tree = jax.tree.map(np.asarray, jstate._asdict())
    _, tcfg = _cfgs("recurrentgemma_2b")
    back = M.train_state_to_numpy(M.train_state_from_numpy(tree, tcfg, CPU))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
