"""Gloo worlds of the port's sharded LM, for the CPU tests.

A world is N ranks of ``LM_SCRIPT`` started by ``_dist_worlds.start_world``
(gloo over a ``file://`` store, one deadline for the whole world, every
rank's log in the world's tmp dir).  The spec's ``cases`` say what each
rank runs on its ``DeviceMesh``; each rank writes ``out<rank>.npz`` (its
blocks and the numbers to compare) and ``out<rank>.json`` (collective
counts and small results).  The one-rank path each case is held against
runs in the rank itself, before the mesh is installed, from the same
seeded weights and inputs: the smoke sizes make that cheap, and it keeps
both sides in one process."""
from __future__ import annotations

import pathlib

from _dist_worlds import start_world, wait_world

LM_SCRIPT = r"""
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh

torch.set_num_threads(1)
rank, world, spec = int(sys.argv[1]), int(sys.argv[2]), json.load(open(sys.argv[3]))
tdist.init_process_group("gloo", init_method=spec["store"], rank=rank,
                         world_size=world)
from repro_torch import configs
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import model as M, moe as MOE
from repro_torch.models import placement as PL, sharding as SH
from repro_torch.serve import serve as S
from repro_torch.train import init_train_state, make_train_step
from repro_torch.launch import train as launch_train

CPU = torch.device("cpu")
out, info = {}, {}


def cfg_of(case):
    cfg = configs.get_smoke(case["arch"])
    return dataclasses.replace(cfg, **case.get("replace", {}))


def plain():
    SH.set_activation_axes(None, None)


def meshed():
    SH.set_activation_axes(mesh_axes(mesh), mesh)
    SH.COMM.log = []
    return SH.COMM


def tokens_batch(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "audio_frames":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(b, t, cfg.frontend_dim)), dtype=torch.float32)
    else:
        batch["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab, (b, t)),
                                          dtype=torch.int32)
    if cfg.frontend == "vision_patches":
        batch["patches"] = torch.as_tensor(
            rng.normal(size=(b, cfg.n_prefix, cfg.frontend_dim)),
            dtype=torch.float32)
    return batch


def by_tag(comm):
    got = {}
    for c in comm.log:
        k = f"{c.op}/{c.tag}"
        n, b = got.get(k, (0, 0))
        got[k] = (n + 1, b + c.nbytes)
    return got


def decode(model, tokens, gen):
    # a 4-token prefill through decode_step, then gen greedy tokens:
    # (the prefill's last logits, the tokens), generate's own loop
    logits, cache = S.prefill(model, tokens[:, :4], 4 + gen + 1)
    toks, _ = S.decode_loop(model, logits, cache, gen)
    return logits, toks


def case_lm(case):
    # forward and (where the arch decodes) greedy decode, plain then mesh
    cfg, name = cfg_of(case), case["name"]
    b, t, gen = case["batch"], case["seq"], case["gen"]
    batch = tokens_batch(cfg, b, t, 1)
    comm = meshed()
    mine = SH.shard_batch(batch)
    # the one-rank path on this rank's data block (an MoE's capacity
    # depends on the tokens it routes together)
    plain()
    whole = M.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    with torch.no_grad():
        want = M.forward(whole, mine)
    if cfg.supports_decode:
        want_dec, want_tok = decode(whole, mine["tokens"], gen)
    comm = meshed()
    model = PL.shard_model(whole)
    with torch.no_grad():
        got = M.forward(model, mine)
    out[name + "/fwd_got"] = got.float().numpy()
    out[name + "/fwd_want"] = want.float().numpy()
    if cfg.supports_decode:
        got_dec, got_tok = decode(model, mine["tokens"], gen)
        out[name + "/dec_got"] = got_dec.float().numpy()
        out[name + "/dec_want"] = want_dec.float().numpy()
        out[name + "/tok_got"] = got_tok.numpy()
        out[name + "/tok_want"] = want_tok.numpy()
    info[name] = by_tag(comm)
    plain()


def case_moe(case):
    # arctic-smoke's MoE block on the rank's data block: the mesh path and
    # the plain path on the same block
    cfg, name = cfg_of(case), case["name"]
    data = np.load(case["data"])
    p = {k[2:]: torch.as_tensor(data[k]) for k in data.files
         if k.startswith("p/")}
    x = torch.as_tensor(data["x"])
    comm = meshed()
    axes = SH.ACT_AXES
    specs = SH.param_specs(cfg, {k: v.shape for k, v in p.items()}, axes)
    blocks = {k: SH.local_block(v, specs[k], *SH.mesh_coords(comm))
              for k, v in p.items()}
    xb = SH.shard_batch({"x": x})["x"]
    got = MOE.moe_block(blocks, xb, cfg)
    out[name + "/got"] = got.numpy()
    info[name] = by_tag(comm)
    plain()
    out[name + "/plain"] = MOE.moe_block(p, xb, cfg).numpy()


def state_arrays(state, prefix):
    tree = M.train_state_to_numpy(state)
    for i, leaf in enumerate(leaves(tree)):
        out[f"{prefix}/{i}"] = np.asarray(leaf, np.float32)


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def case_train(case):
    # two steps of the plain state and of the sharded state, the batch the
    # same; the gathered state, a checkpoint of it, and a restore of a
    # one-process checkpoint onto the mesh
    cfg, name = cfg_of(case), case["name"]
    kw = dict(grad_dtype=case.get("grad_dtype"))
    batches = [launch_train.synthetic_lm_batch(cfg, case["batch"], case["seq"],
                                               s, device=CPU)
               for s in range(2)]
    plain()
    state = init_train_state(cfg, torch.Generator().manual_seed(0), CPU)
    init = M.train_state_to_numpy(state)
    step = make_train_step(cfg, **kw)
    want = []
    for bt in batches:
        state, m = step(state, bt)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    state_arrays(state, name + "/want")
    comm = meshed()
    sharded = PL.shard_train_state(M.train_state_from_numpy(init, cfg, CPU))
    step = make_train_step(cfg, **kw)
    got = []
    for bt in batches:
        sharded, m = step(sharded, SH.shard_batch(bt))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    info[name] = dict(by_tag(comm), want=want, got=got)
    whole = PL.gather_train_state(sharded)
    state_arrays(whole, name + "/got")
    if case.get("ckpt"):
        from repro_torch.checkpoint import restore_train_state, save_train_state
        save_train_state(sharded, case["ckpt"], 2, data_offset=2)
        back, _ = restore_train_state(sharded, case["one_ckpt"])
        want_back = PL.shard_train_state(back_whole(cfg, case["one_ckpt"]))
        same = all(torch.equal(a, b) for a, b in zip(
            back.model.parameters(), want_back.model.parameters()))
        same &= all(torch.equal(back.opt[k][n], want_back.opt[k][n])
                    for k in ("m", "v") for n in back.opt[k])
        info[name]["restored_blocks_equal"] = bool(same)
    plain()


def back_whole(cfg, directory):
    from repro_torch.checkpoint import restore_train_state
    plain()
    tmpl = init_train_state(cfg, torch.Generator().manual_seed(0), CPU)
    st, _ = restore_train_state(tmpl, directory)
    meshed()
    return st


def case_launch(case):
    # the launchers' own functions under the process group: --mesh local
    name = case["name"]
    from repro_torch.launch import serve as launch_serve
    res = launch_serve.serve_lm(launch_serve.build_parser().parse_args(
        case["serve"]), CPU)
    out[name + "/tokens"] = res["tokens"].numpy()
    info[name + "/serve_axes"] = SH.ACT_AXES.sizes
    res = launch_train.train_lm(launch_train.build_parser().parse_args(
        case["train"]), CPU)
    info[name] = dict(losses=[float(m["loss"]) for m in res["metrics"]],
                      gnorms=[float(m["grad_norm"]) for m in res["metrics"]],
                      counts={f"{op}/{tag}": v[:2] for (op, tag), v
                              in SH.COMM.counts.items()})
    plain()


try:
    mesh = init_device_mesh("cpu", tuple(spec["shape"]),
                            mesh_dim_names=tuple(spec["names"]))
    for case in spec["cases"]:
        globals()["case_" + case["kind"]](case)
    np.savez(f"{spec['out']}{rank}.npz", **out)
    with open(f"{spec['out']}{rank}.json", "w") as fh:
        json.dump(info, fh)
finally:
    tdist.destroy_process_group()
"""


def start_lm_world(tmp: pathlib.Path, shape, cases, names=("data", "model"),
                   timeout=120.0):
    """Start an LM world (see ``LM_SCRIPT``); ``wait_world`` joins it."""
    return start_world(tmp, shape, names, cases, "", script=LM_SCRIPT,
                       timeout=timeout)


__all__ = ["LM_SCRIPT", "start_lm_world", "wait_world"]
