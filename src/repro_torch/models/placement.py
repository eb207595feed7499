"""Placing the LM on a mesh: a whole model to the rank's sharded model and
back, by the rules of ``sharding.param_specs``.

``shard_model`` cuts every parameter of a whole ``LM`` to this rank's block
(``sharding.local_block``), so the model's own modules run on blocks, and
hands each module its specs.  ``gather_model`` rebuilds the whole model
from the blocks with ``Collectives.all_gather`` (every rank takes part and
every rank gets it).  The same two go for a train state: the AdamW moments
are cut and gathered by their parameter's spec.  Weights carried across
from the JAX package (``model.params_from_numpy``) compose with
``shard_model``.
"""
from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.models import sharding as SH

__all__ = ["shard_model", "gather_model", "shard_train_state",
           "gather_train_state", "gather_named", "is_sharded"]


def _mesh(comm, axes):
    comm = SH.COMM if comm is None else comm
    axes = SH.ACT_AXES if axes is None else axes
    if comm is None or axes is None:
        raise ValueError("no mesh: install one with set_activation_axes, or "
                         "pass comm and axes")
    return comm, axes


def is_sharded(model) -> bool:
    return getattr(model, "specs", None) is not None


def _attach(model, specs: dict):
    """Every module's specs under its own parameter names."""
    model.specs = specs
    for l, layer in enumerate(model.layers):
        pre = f"layers.{l}."
        layer.specs = {n[len(pre):]: s for n, s in specs.items()
                       if n.startswith(pre)}


def _cut(named: dict, specs: dict, comm) -> dict:
    coords, sizes = SH.mesh_coords(comm)
    return {n: SH.local_block(t.detach(), specs[n], coords, sizes).clone()
            for n, t in named.items()}


def shard_model(model, comm=None, axes=None):
    """This rank's sharded ``LM`` of a whole one (on the installed mesh
    unless ``comm`` / ``axes`` are given).  The whole model is not
    changed."""
    comm, axes = _mesh(comm, axes)
    specs = SH.param_specs(model.cfg, model, axes)
    out = M.lm_from_named(model.cfg, _cut(dict(model.named_parameters()),
                                          specs, comm))
    _attach(out, specs)
    return out


def gather_named(named: dict, specs: dict, comm=None) -> dict:
    """{name: block} whole again: one tiled all-gather over the axes of
    each split dim (tag ``"gather_model"``)."""
    comm = SH.COMM if comm is None else comm
    out = {}
    for n, t in named.items():
        t = t.detach()
        for d, e in enumerate(specs[n]):
            if e is not None:
                axs = e if isinstance(e, tuple) else (e,)
                t = comm.all_gather(t, axs, "gather_model", dim=d)
        out[n] = t
    return out


def gather_model(model, comm=None):
    """The whole ``LM`` of a sharded one (every rank takes part)."""
    return M.lm_from_named(model.cfg, gather_named(
        dict(model.named_parameters()), model.specs, comm))


def shard_train_state(state, comm=None, axes=None):
    """A whole ``train.TrainState`` cut to this rank's blocks."""
    from repro_torch.train.train_step import TrainState
    model = shard_model(state.model, comm, axes)
    comm, _ = _mesh(comm, axes)
    opt = {k: _cut(state.opt[k], model.specs, comm) for k in ("m", "v")}
    opt["step"] = state.opt["step"].clone()
    return TrainState(model, opt)


def gather_train_state(state, comm=None):
    """The whole ``train.TrainState`` of a sharded one."""
    from repro_torch.train.train_step import TrainState
    opt = {k: gather_named(state.opt[k], state.model.specs, comm)
           for k in ("m", "v")}
    opt["step"] = state.opt["step"]
    return TrainState(gather_model(state.model, comm), opt)
