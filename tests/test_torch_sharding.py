"""The sharded LM's rules in the port (``repro_torch.models.sharding``)
against the reference's (``repro.models.sharding``), and the pure block
functions.

* ``param_specs`` equals the reference's leaf for leaf, exactly, on all ten
  configs at both production meshes (16x16 and 2x16x16; sizes only, no
  process group): the reference's specs come from ``jax.eval_shape``, the
  port's from a model built on ``torch.device("meta")``.  The reference's
  grouped leaves carry a leading ``None`` for the stacked layer dim, which
  the port (one module per layer) drops.
* ``cache_specs`` equals the reference's on every decode config's cache.
* Ports of ``tests/test_sharding_rules.py``'s four checks.
* ``local_block`` / ``assemble`` round-trip every leaf of every smoke
  config at 2x2 and 1x4, and every leaf of a 2x2x2 FSDP config.
"""
import dataclasses
import itertools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import sharding as JSH
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models import sharding as SH

MESHES = {
    "16x16": (("data",), {"data": 16, "model": 16}),
    "2x16x16": (("pod", "data"), {"pod": 2, "data": 16, "model": 16}),
}
META = torch.device("meta")


def _axes(mesh, mod):
    data, sizes = MESHES[mesh]
    return mod.MeshAxes(data=data, model="model", sizes=dict(sizes))


def _port_names(cfg, tree):
    """{port parameter name: leaf} of a reference-layout tree whose leaves
    may be PartitionSpecs (tuples, which ``_unstack`` would walk into)."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    n = len(cfg.pattern)
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "groups":
            p, rest = keys[1], ".".join(str(k) for k in keys[2:])
            for g in range(cfg.n_groups):
                out[f"layers.{g * n + p}.{rest}"] = (leaf, True)
        elif keys[0] == "remainder":
            i, rest = keys[1], ".".join(str(k) for k in keys[2:])
            out[f"layers.{cfg.n_groups * n + i}.{rest}"] = (leaf, False)
        else:
            out[".".join(str(k) for k in keys)] = (leaf, False)
    return out


def _ref_param_specs(arch, mesh):
    cfg = jconfigs.get(arch)
    structs = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                             jax.random.key(0))
    specs = JSH.param_specs(cfg, structs, _axes(mesh, JSH))
    return {n: tuple(s)[1:] if stacked else tuple(s)
            for n, (s, stacked) in _port_names(cfg, specs).items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh):
    cfg = configs.get(arch)
    model = M.init_params(cfg, device=META)
    got = SH.param_specs(cfg, model, _axes(mesh, SH))
    want = _ref_param_specs(arch, mesh)
    assert got.keys() == want.keys()
    bad = {n: (got[n], want[n]) for n in got if got[n] != want[n]}
    assert not bad, bad
    for n, p in model.named_parameters():       # padded to rank
        assert len(got[n]) == p.dim(), n


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if configs.get(a).supports_decode])
def test_cache_specs_equal_reference(arch):
    cfg = configs.get_smoke(arch)
    jcache = jax.eval_shape(lambda: JM.init_cache(jconfigs.get_smoke(arch),
                                                  4, 8))
    for mesh in ("16x16", "2x16x16"):
        for b in (4, 64):
            want = JSH.cache_specs(jconfigs.get_smoke(arch), jcache,
                                   _axes(mesh, JSH), b)
            got = SH.cache_specs(cfg, M.init_cache(cfg, 4, 8, META),
                                 _axes(mesh, SH), b)
            flat = _port_names(cfg, {k: v for k, v in want.items()
                                     if k != "index"})
            for name, (spec, stacked) in flat.items():
                layer, *path = name.split(".")[1:]
                node = got["layers"][int(layer)]
                for k in path:
                    node = node[int(k) if isinstance(node, tuple) else k]
                assert node == (tuple(spec)[1:] if stacked else tuple(spec)), \
                    (arch, mesh, b, name)
            assert got["index"] == tuple(want["index"])


def _check_divisible(cfg, axes):
    model = M.init_params(cfg, device=META)
    specs = SH.param_specs(cfg, model, axes)
    for n, p in model.named_parameters():
        for dim, part in zip(p.shape, specs[n]):
            if part is None:
                continue
            parts = part if isinstance(part, tuple) else (part,)
            assert dim % int(np.prod([axes.sizes[a] for a in parts])) == 0, n


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_divisible_single_pod(arch):
    _check_divisible(configs.get(arch), _axes("16x16", SH))


@pytest.mark.parametrize("arch", ["arctic_480b", "gemma_7b", "xlstm_125m"])
def test_param_specs_divisible_multi_pod(arch):
    _check_divisible(configs.get(arch), _axes("2x16x16", SH))


def test_moe_experts_sharded_over_model():
    cfg = configs.get("arctic_480b")
    specs = SH.param_specs(cfg, M.init_params(cfg, device=META),
                           _axes("16x16", SH))
    sp = specs["layers.0.moe.w_gate"]             # [E, D, F]
    assert sp[0] == "model"                       # experts on the model axis
    assert sp[2] == "data"                        # fsdp on d_ff


def test_indivisible_heads_fall_back_to_replication():
    cfg = configs.get("smollm_360m")              # 15 heads vs 16-way axis
    specs = SH.param_specs(cfg, M.init_params(cfg, device=META),
                           _axes("16x16", SH))
    assert "model" not in specs["layers.0.kind_params.wq"]


def _round_trip(cfg, names, sizes):
    axes = SH.MeshAxes(data=names[:-1], model="model", sizes=sizes)
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = SH.param_specs(cfg, model, axes)
    grid = [range(sizes[a]) for a in names]
    for n, p in model.named_parameters():
        blocks = {}
        for idx in itertools.product(*grid):
            coords = dict(zip(names, idx))
            blocks[tuple(coords.items())] = SH.local_block(p, specs[n],
                                                          coords, sizes)
        assert torch.equal(SH.assemble(blocks, specs[n], sizes), p), n
        as_np = {c: b.detach().numpy() for c, b in blocks.items()}
        np.testing.assert_array_equal(SH.assemble(as_np, specs[n], sizes),
                                      p.detach().numpy())


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_local_block_assemble_round_trip(arch, shape):
    d, m = (int(x) for x in shape.split("x"))
    _round_trip(configs.get_smoke(arch), ("data", "model"),
                {"data": d, "model": m})


def test_local_block_assemble_round_trip_fsdp_multi_pod():
    cfg = dataclasses.replace(configs.get_smoke("arctic_480b"),
                              param_sharding="fsdp")
    _round_trip(cfg, ("pod", "data", "model"),
                {"pod": 2, "data": 2, "model": 2})


def test_shard_batch_follows_btd():
    """Rows over the data axes when they divide the batch, else whole."""
    from repro_torch.core.collectives import RecordingCollectives
    comm = RecordingCollectives((("data", 2), ("model", 2)))
    axes = SH.MeshAxes(sizes={"data": 2, "model": 2})
    x = torch.arange(12).reshape(4, 3)
    assert torch.equal(SH.shard_batch({"x": x}, axes, comm)["x"], x[:2])
    y = torch.arange(9).reshape(3, 3)
    assert torch.equal(SH.shard_batch({"y": y}, axes, comm)["y"], y)
