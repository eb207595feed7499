"""The dry run's abstract inputs, states and layouts
(``repro_torch.launch.specs``) against the reference's
(``repro.launch.specs``), at the published configs.

* ``input_specs``: every (arch, shape) cell's inputs have the shapes and
  dtypes of the reference's ``ShapeDtypeStruct``s; a decode cache layer
  for layer, through the grouped layout (group ``g`` at pattern position
  ``p`` is layer ``g * len(pattern) + p``).
* ``state_structs``: every parameter's and AdamW moment's shape and dtype
  equal the reference's ``eval_shape`` state.
* ``batch_shardings`` / ``state_shardings`` / ``decode_shardings`` at
  16x16 and 2x16x16 equal the reference's, called with an
  ``AbstractMesh`` (no devices), spec for spec; the reference's stacked
  layer dim (a leading ``None``) is dropped, as in
  ``tests/test_torch_sharding.py``.
* ``fake_state`` / ``fake_inputs`` give each rank's block shapes
  (``sharding.local_block``) as fake tensors.
"""
import functools

import pytest
torch = pytest.importorskip("torch")

import jax
from jax.sharding import AbstractMesh, PartitionSpec
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.launch.mesh import mesh_axes as jmesh_axes
from repro_torch import configs
from repro_torch.launch import dryrun, specs
from repro_torch.models import sharding as SH

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _ref_leaves(tree) -> list:
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def _per_layer(cfg, tree, fn):
    """The reference's grouped tree (``groups`` / ``remainder``) as one
    list of ``fn(leaf, stacked)`` per layer, in layer order."""
    out = [None] * cfg.n_layers
    n = len(cfg.pattern)
    for p, gp in enumerate(tree["groups"]):
        for g in range(cfg.n_groups):
            out[g * n + p] = [fn(x, True) for x in _ref_leaves(gp)]
    for i, rp in enumerate(tree["remainder"]):
        out[cfg.n_groups * n + i] = [fn(x, False) for x in _ref_leaves(rp)]
    return out


def _shape_of(x, stacked):
    return tuple(x.shape[1:] if stacked else x.shape), _dtype(x)


def _spec_of(x, stacked):
    return _norm(x)[1:] if stacked else _norm(x)


def _norm(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return jspecs.state_structs(jconfigs.get(arch))


def _ref_mesh(mesh):
    m = AbstractMesh(*MESHES[mesh])
    return m, jmesh_axes(m)


def _port_axes(mesh):
    return dryrun.production_comm(mesh)[1]


@pytest.mark.parametrize("shape", list(configs.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_equal_reference(arch, shape):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    got, want = specs.input_specs(cfg, shape), jspecs.input_specs(jcfg, shape)
    assert sorted(got) == sorted(want)
    for k in got:
        if k == "cache":
            continue
        assert (tuple(got[k].shape), _dtype(got[k])) == (
            tuple(want[k].shape), _dtype(want[k])), k
        assert got[k].device.type == "meta"
    if "cache" not in got:
        return
    ref = _per_layer(cfg, want["cache"], _shape_of)
    for layer, st in enumerate(got["cache"]["layers"]):
        assert [(tuple(x.shape), _dtype(x)) for x in _leaves(st)] == \
            ref[layer], layer
    assert (tuple(got["cache"]["index"].shape),
            _dtype(got["cache"]["index"])) == ((), "int32")


def _by_port_name(cfg, tree, fn) -> dict:
    """{port parameter name: fn(leaf, stacked)} of a reference-layout
    tree (top-level leaves, ``groups``, ``remainder``)."""
    out = {}
    n = len(cfg.pattern)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        rest = ".".join(str(k) for k in keys[2:])
        if keys[0] == "groups":
            for g in range(cfg.n_groups):
                out[f"layers.{g * n + keys[1]}.{rest}"] = fn(leaf, True)
        elif keys[0] == "remainder":
            out[f"layers.{cfg.n_groups * n + keys[1]}.{rest}"] = fn(leaf,
                                                                   False)
        else:
            out[".".join(str(k) for k in keys)] = fn(leaf, False)
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_state_structs_equal_reference(arch):
    """Every parameter and both moments: shape and dtype, by name."""
    cfg = configs.get(arch)
    got = specs.state_structs(cfg)
    want = _ref_state(arch)
    assert got.model.device.type == "meta"

    assert {n: (tuple(p.shape), _dtype(p))
            for n, p in got.model.named_parameters()} == _by_port_name(
                cfg, want.params, _shape_of)
    for k in ("m", "v"):
        assert {n: (tuple(t.shape), _dtype(t))
                for n, t in got.opt[k].items()} == _by_port_name(
                    cfg, want.opt[k], _shape_of), k
    assert (tuple(got.opt["step"].shape), _dtype(got.opt["step"])) == (
        tuple(want.opt["step"].shape), _dtype(want.opt["step"]))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shardings_equal_reference(arch, mesh):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    jm, jaxes = _ref_mesh(mesh)
    axes = _port_axes(mesh)
    # batch: every train / prefill cell's batch
    for shape in configs.SHAPES:
        if configs.SHAPES[shape][2] == "decode":
            continue
        got = specs.batch_shardings(specs.input_specs(cfg, shape), axes)
        want = jspecs.batch_shardings(jspecs.input_specs(jcfg, shape), jm,
                                      jaxes)
        assert {k: _norm(v) for k, v in got.items()} == {
            k: _norm(v.spec) for k, v in want.items()}, shape
    # state: parameters and moments by name, step replicated
    state = specs.state_structs(cfg)
    got = specs.state_shardings(cfg, state, axes)
    want = jspecs.state_shardings(jcfg, _ref_state(arch), jm, jaxes)
    ref_specs = SH.param_specs(cfg, state.model, axes)
    assert got.model == ref_specs
    assert got.opt["m"] == ref_specs and got.opt["v"] == ref_specs
    assert got.opt["step"] == () and _norm(want.opt["step"].spec) == ()
    spec_tree = jax.tree.map(lambda sh: sh.spec, want.params)
    ref = _by_port_name(cfg, spec_tree, _spec_of)
    assert {n: _norm(s) for n, s in got.model.items()} == ref
    # decode: tokens and the cache, layer for layer
    for shape in configs.SHAPES:
        if (configs.SHAPES[shape][2] != "decode"
                or configs.shape_skip_reason(cfg, shape)):
            continue
        ins = specs.input_specs(cfg, shape)
        got = specs.decode_shardings(cfg, ins, axes)
        want = jspecs.decode_shardings(jcfg, jspecs.input_specs(jcfg, shape),
                                       jm, jaxes)
        assert _norm(got["tokens"]) == _norm(want["tokens"].spec)
        ref = _per_layer(cfg, jax.tree.map(lambda s: s.spec, want["cache"]),
                         _spec_of)
        for layer, st in enumerate(got["cache"]["layers"]):
            mine = st if isinstance(st, tuple) else [st[k]
                                                     for k in sorted(st)]
            assert [_norm(s) for s in mine] == ref[layer], (shape, layer)
        assert _norm(got["cache"]["index"]) == ()


def test_fake_state_and_inputs_are_rank_blocks():
    """smollm-360m at 16x16: each parameter and moment a fake tensor of
    the rank's block shape, the specs attached; the decode inputs cut to
    the rank's rows and kv heads."""
    cfg = configs.get("smollm_360m")
    comm, axes = dryrun.production_comm("16x16")
    coords, sizes = SH.mesh_coords(comm)
    meta = specs.state_structs(cfg)
    pspec = SH.param_specs(cfg, meta.model, axes)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    state = specs.fake_state(cfg, mode, "cpu", comm, axes)
    assert state.model.specs == pspec
    for n, p in state.model.named_parameters():
        assert isinstance(p, FakeTensor) and p.device.type == "cpu"
        want = SH.local_block(dict(meta.model.named_parameters())[n],
                              pspec[n], coords, sizes).shape
        assert p.shape == want and state.opt["m"][n].shape == want, n
    ins = specs.input_specs(cfg, "decode_32k")
    fake = specs.fake_inputs(ins, mode, "cpu", comm,
                             specs.decode_shardings(cfg, ins, axes))
    assert fake["tokens"].shape == (128 // 16, 1)
    k = fake["cache"]["layers"][0]["k"]
    assert isinstance(k, FakeTensor)
    assert k.shape == (8, 32_768, cfg.n_kv, cfg.head_dim)   # 5 kv heads
    whole = specs.fake_inputs(specs.input_specs(cfg, "train_4k"), mode)
    assert whole["tokens"].shape == (256, 4096)
