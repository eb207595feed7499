"""Abstract inputs, states and their layouts for every dry-run cell
(counterpart of ``repro.launch.specs``).

``input_specs(cfg, shape_id)`` returns the cell step's inputs as tensors on
``torch.device("meta")`` (shapes and dtypes, nothing allocated), with the
reference's ``ShapeDtypeStruct`` shapes and dtypes: the batch for
train / prefill, one token and the cache for decode.  ``state_structs``
gives the train state on the meta device.  The ``*_shardings`` functions
give spec trees in the form of ``models.sharding.param_specs`` /
``cache_specs`` (a tuple per tensor, one entry per dim), where the
reference gives ``NamedSharding`` trees.

``fake_state`` / ``fake_inputs`` turn those into one rank's blocks as fake
tensors (``FakeTensorMode``) on a device of choice, which is how the dry
run records a giant's step without allocating it.  Two things that fail
are done another way there: a model built on the meta device cannot run
under ``FakeTensorMode`` (its parameters are meta, the activations not),
so every tensor is made again as a fake one of the same shape and dtype;
and ``init_train_state`` cannot run inside the mode (``trunc_normal_``
reads ``mask.any()``), so the meta state is made outside it.  On a
PyTorch build without CUDA, record on fake ``cpu`` tensors: autograd
aborts the process on a fake ``cuda`` parameter there.
"""
from __future__ import annotations

import torch

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models import placement
from repro_torch.models import sharding as SH
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import MeshAxes, cache_specs, param_specs
from repro_torch.train.train_step import TrainState, init_train_state

__all__ = ["input_specs", "batch_shardings", "state_structs",
           "state_shardings", "decode_shardings", "fake_state",
           "fake_inputs"]

META = torch.device("meta")


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape_id: str, seq: int | None = None):
    """Abstract inputs for the cell's step (``seq`` in place of the
    shape's own length, for the dry run's time-loop fit).

    train/prefill: batch dict.  decode: tokens [B,1] and the whole cache at
    seq_len (call with no mesh installed: under one ``init_cache`` makes a
    rank's block).  [audio]/[vlm]: precomputed frame/patch embeddings."""
    shape_seq, batch, kind = configs.SHAPES[shape_id]
    seq = shape_seq if seq is None else seq
    if kind in ("train", "prefill"):
        out = {}
        if cfg.frontend == "audio_frames":
            out["frames"] = _sds((batch, seq, cfg.frontend_dim),
                                 torch.bfloat16)
            if kind == "train":
                out["labels"] = _sds((batch, seq), torch.int32)
            return out
        if cfg.frontend == "vision_patches":
            out["patches"] = _sds((batch, cfg.n_prefix, cfg.frontend_dim),
                                  torch.bfloat16)
            seq = seq - cfg.n_prefix          # total positions = shape seq
        out["tokens"] = _sds((batch, seq), torch.int32)
        if kind == "train":
            out["labels"] = _sds((batch, seq), torch.int32)
        return out
    cache = M.init_cache(cfg, batch, seq, device=META)
    return {"tokens": _sds((batch, 1), torch.int32), "cache": cache}


def batch_shardings(tree: dict, axes: MeshAxes) -> dict:
    """Batch-dim spec over the data axes (replicated if indivisible)."""
    dsz = axes.dsize()

    def spec(leaf):
        if not leaf.shape:
            return ()
        ok = leaf.shape[0] % dsz == 0
        return (SH.data_entry(axes) if ok else None,
                *([None] * (len(leaf.shape) - 1)))

    return {k: spec(v) for k, v in tree.items()}


def state_structs(cfg: ModelConfig) -> TrainState:
    """The train state on the meta device (giants never materialise)."""
    return init_train_state(cfg, device=META)


def state_shardings(cfg: ModelConfig, state_struct: TrainState,
                    axes: MeshAxes) -> TrainState:
    """The state's specs: the parameters' by ``param_specs``, each AdamW
    moment its parameter's, ``step`` replicated."""
    pspec = param_specs(cfg, state_struct.model, axes)
    return type(state_struct)(pspec, {"m": pspec, "v": pspec, "step": ()})


def decode_shardings(cfg: ModelConfig, ins: dict, axes: MeshAxes) -> dict:
    b = ins["tokens"].shape[0]
    cspec = cache_specs(cfg, ins["cache"], axes, b)
    tok = (SH.data_entry(axes) if b % axes.dsize() == 0 else None, None)
    return {"tokens": tok, "cache": cspec}


def _block(t, spec, comm, device):
    """A fake tensor shaped as the rank's block of ``t`` (``comm`` None:
    the whole of it)."""
    if comm is not None and spec is not None:
        coords, sizes = SH.mesh_coords(comm)
        t = SH.local_block(t, spec, coords, sizes)
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def _map(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _map(v, None if specs is None else specs[k], fn)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, None if specs is None else specs[i], fn)
                          for i, v in enumerate(tree))
    return fn(tree, specs)


def fake_state(cfg: ModelConfig, mode, device="cpu", comm=None,
               axes: MeshAxes | None = None) -> TrainState:
    """The train state as fake tensors of ``mode`` (a ``FakeTensorMode``)
    on ``device``: whole, or with ``comm`` and ``axes`` this rank's sharded
    state (``placement.shard_train_state``'s shapes, its specs attached)."""
    meta = state_structs(cfg)
    specs = param_specs(cfg, meta.model, axes) if comm is not None else None
    with mode:
        named = {n: _block(p, None if specs is None else specs[n], comm,
                           device)
                 for n, p in meta.model.named_parameters()}
        model = M.lm_from_named(cfg, named)
        opt = {k: {n: _block(t, None if specs is None else specs[n], comm,
                             device)
                   for n, t in meta.opt[k].items()} for k in ("m", "v")}
        opt["step"] = torch.zeros((), dtype=torch.int32, device=device)
    if specs is not None:
        placement.attach_specs(model, specs)
    return TrainState(model, opt)


def fake_inputs(tree, mode, device="cpu", comm=None, specs=None):
    """``tree`` (``input_specs``' meta tensors) as fake tensors of ``mode``
    on ``device``: whole, or with ``comm`` the rank's blocks by ``specs``
    (``batch_shardings`` / ``decode_shardings``' tree)."""
    with mode:
        return _map(tree, specs, lambda t, s: _block(t, s, comm, device))
