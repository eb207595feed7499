"""Port parity for the LM serving path as a whole on the CPU: the
architecture registry, ``models.model`` (forward, decode_step, the caches),
``serve.serve`` (generate) and ``launch.serve`` in both of its modes.

The reference's weights (``init_params(jax.random.key(0), cfg)``, every leaf
through ``np.asarray``) are carried across with ``params_from_numpy``;
inputs come from numpy with a seed.  Tolerances: rtol = atol = 1e-4 in f32
(``dataclasses.replace(cfg, dtype="float32")``); 5e-2 at the configs' own
bf16 (the reference's decode-vs-forward tolerance,
tests/test_recurrences.py); tokens and the registry exact.

Decode in f32 is the one place where those bounds cannot hold: both
packages keep the attention cache's k and v in bf16 whatever cfg.dtype
is, so a key or value whose f32 value differs in its last bit between the
two packages can round to neighbouring bf16 values.  Such leaves are held
to one bf16 ulp (rtol 2**-7), and the decode logits in f32 to 1e-3: one
bf16 ulp of a cached value reaches the logits at up to 3.9e-4 in these
smoke runs (llama4 smoke, three flipped values after the first step).
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serve import generate as jgenerate
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.serve import generate

CPU = "cpu"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
F32_DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_ULP_TOL = dict(rtol=2 ** -7, atol=0.0)
DECODE_ARCHS = [a for a in jconfigs.ARCH_IDS
                if jconfigs.get(a).supports_decode]


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def ref():
    """arch -> the reference's smoke parameters (jax) and their numpy tree,
    each built once."""
    built = {}

    def get(arch):
        if arch not in built:
            params = JM.init_params(jax.random.key(0),
                                    jconfigs.get_smoke(arch))
            built[arch] = (params, jax.tree.map(np.asarray, params))
        return built[arch]
    return get


def _cfgs(arch, dtype):
    jc, tc = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    return (dataclasses.replace(jc, dtype=dtype),
            dataclasses.replace(tc, dtype=dtype))


def _batch(cfg, b=2, t=16, seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio_frames":
        out["frames"] = rng.normal(size=(b, t, cfg.frontend_dim)).astype(
            np.float32)
        return out
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.normal(
            size=(b, cfg.n_prefix, cfg.frontend_dim)).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab, size=(b, t)).astype(np.int32)
    return out


# -- the architecture registry ----------------------------------------------


def test_registry_tables_equal_the_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.ALIASES == jconfigs.ALIASES
    assert configs.SHAPES == jconfigs.SHAPES
    assert configs.cells() == jconfigs.cells()


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_reference_field_for_field(arch):
    for getter in ("get", "get_smoke"):
        jc = getattr(jconfigs, getter)(arch)
        tc = getattr(configs, getter)(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        for s in configs.SHAPES:
            assert (configs.shape_skip_reason(tc, s)
                    == jconfigs.shape_skip_reason(jc, s))
    alias = [k for k, v in configs.ALIASES.items() if v == arch][0]
    assert configs.get(alias) == configs.get(arch)


# -- forward ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_forward_matches_the_reference(ref, arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    params, tree = ref(arch)
    batch = _batch(jc)
    want = jax.jit(lambda p, b: JM.forward(p, jc, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = M.params_from_numpy(tree, tc, device=CPU)
    with torch.no_grad():
        got = M.forward(model, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert got.dtype == {"float32": torch.float32,
                         "bfloat16": torch.bfloat16}[dtype]
    assert got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


# -- decode ------------------------------------------------------------------


def _cache_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _cache_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _cache_leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_steps_and_caches_match_the_reference(ref, arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    logit_tol = F32_DECODE_TOL if dtype == "float32" else BF16_TOL
    params, tree = ref(arch)
    toks = np.random.default_rng(2).integers(0, jc.vocab, size=(2, 3)).astype(
        np.int32)
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jc, t, c))
    jcache = JM.init_cache(jc, 2, max_len=12)
    model = M.params_from_numpy(tree, tc, device=CPU)
    tcache = M.init_cache(tc, 2, max_len=12, device=CPU)
    for s in range(3):
        jl, jcache = step(params, jnp.asarray(toks[:, s:s + 1]), jcache)
        tl, tcache = M.decode_step(model, torch.from_numpy(toks[:, s:s + 1]),
                                   tcache)
        assert tl.shape == (2, 1, jc.vocab)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **logit_tol)
    assert int(tcache["index"]) == 3
    want = list(_cache_leaves(jax.tree.map(np.asarray, jcache)))
    got = list(_cache_leaves(M.cache_to_numpy(tcache, tc)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            tol = (BF16_ULP_TOL if w.dtype.name == "bfloat16"
                   and dtype == "float32" else _tol(dtype))
            np.testing.assert_allclose(g, w.astype(np.float32),
                                       err_msg=str(path), **tol)
    # and back: the reference's cache carried across decodes the same
    back = M.cache_from_numpy(jax.tree.map(np.asarray, jcache), tc, CPU)
    tl, _ = M.decode_step(model, torch.from_numpy(toks[:, :1]), back)
    jl, _ = step(params, jnp.asarray(toks[:, :1]), jcache)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **logit_tol)


# -- generate ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b",
                                  "xlstm_125m", "codeqwen15_7b",
                                  "llama4_maverick_400b_a17b"])
def test_greedy_generate_gives_the_reference_tokens(ref, arch):
    jc, tc = _cfgs(arch, "float32")
    params, tree = ref(arch)
    prompt = np.random.default_rng(3).integers(0, jc.vocab, size=(2, 8)).astype(
        np.int32)
    want = np.asarray(jgenerate(params, jc, jnp.asarray(prompt), 8,
                                max_len=17))
    model = M.params_from_numpy(tree, tc, device=CPU)
    got = generate(model, torch.from_numpy(prompt), 8, max_len=17, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b",
                                  "xlstm_125m", "codeqwen15_7b"])
def test_decode_matches_own_forward(arch):
    """The port's decode logits equal its teacher-forced forward at every
    position, at the config's own bf16 (tests/test_recurrences.py's
    tolerance)."""
    cfg = configs.get_smoke(arch)
    model = M.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 12)).astype(np.int32))
    with torch.no_grad():
        full = M.forward(model, {"tokens": toks}).float()
    cache = M.init_cache(cfg, 2, max_len=13, device=CPU)
    outs = []
    for s in range(12):
        lg, cache = M.decode_step(model, toks[:, s:s + 1], cache)
        outs.append(lg.float())
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **BF16_TOL)


def test_temperature_sampling_is_seeded_and_in_range():
    cfg = configs.get_smoke("smollm_360m")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    prompt = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    runs = [generate(model, prompt, 8, max_len=17, temperature=0.7,
                     generator=torch.Generator().manual_seed(5), device=CPU)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 8)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab
    greedy = generate(model, prompt, 8, max_len=17, device=CPU)
    assert torch.equal(runs[0][:, 0], greedy[:, 0])  # first token: argmax
    with pytest.raises(ValueError, match="Generator"):
        generate(model, prompt, 8, max_len=17, temperature=0.7, device=CPU)


# -- the launcher ----------------------------------------------------------------


def test_launcher_lm_mode_on_the_cpu(capsys):
    launch_serve.main(["--smoke", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("generated (4, 32) in ")
    assert "tok/s" in lines[0]
    args = launch_serve.build_parser().parse_args(["--smoke", "--device",
                                                   "cpu"])
    res = launch_serve.serve_lm(args, CPU)
    toks = res["tokens"]
    assert toks.device.type == "cpu" and toks.shape == (4, 32)
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
    with pytest.raises(ValueError, match="encoder-only"):
        launch_serve.main(["--smoke", "--device", "cpu", "--arch",
                           "hubert-xlarge"])


def test_launcher_forest_mode_on_the_cpu(capsys):
    launch_serve.main(["--forest", "--tenants", "2", "--requests", "10",
                       "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("2 tenants, 10 requests in ")
    assert lines[1].startswith("p50 ") and "serve executables" in lines[1]
    assert lines[2].startswith("packed ")
