"""Logical mesh axes of the LM stack, the one-card subset of
``repro.models.sharding``.

The launcher installs the axes of its mesh (``set_activation_axes``);
``constrain_act`` is where the reference pins an activation's layout to
them.  The port holds every tensor whole on one card, so with no mesh
installed, or a mesh whose axes all have size 1, ``constrain_act`` returns
its input as it is: the reference's ``with_sharding_constraint`` on such a
mesh changes nothing either.  A larger mesh is refused (``NotImplementedError``):
the sharded model -- ``param_specs``, ``cache_specs`` and the MoE mesh
paths -- is ROADMAP item 13c, and no path quietly runs replicated instead.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["MeshAxes", "set_activation_axes", "model_axis_size",
           "heads_shardable", "constrain_act", "mesh_is_trivial"]

SHARDED_ITEM = ("the sharded LM (ROADMAP item 13c) is not ported: the port "
                "runs the model on one card, under no mesh or a 1x1 mesh")


@dataclasses.dataclass
class MeshAxes:
    data: tuple = ("data",)            # batch / fsdp axes ("pod","data") multi-pod
    model: str = "model"
    sizes: dict = dataclasses.field(default_factory=dict)

    def dsize(self):
        return math.prod(self.sizes.get(a, 1) for a in self.data)

    def msize(self):
        return int(self.sizes.get(self.model, 1))


ACT_AXES: MeshAxes | None = None
MESH = None                       # the launcher's DeviceMesh, when it has one


def set_activation_axes(axes: MeshAxes | None, mesh=None):
    global ACT_AXES, MESH
    ACT_AXES = axes
    MESH = mesh


def model_axis_size() -> int:
    return ACT_AXES.msize() if ACT_AXES is not None else 1


def heads_shardable(n: int) -> bool:
    return ACT_AXES is None or n % ACT_AXES.msize() == 0


def mesh_is_trivial() -> bool:
    """No mesh installed, or one whose data and model axes have size 1."""
    return (MESH is None or ACT_AXES is None
            or (ACT_AXES.dsize() == 1 and ACT_AXES.msize() == 1))


def constrain_act(x, kind: str):
    """kind: 'btd' | 'btnh_seq' | 'btv' (logits) | 'ecd' (expert buffers).
    The identity on one card; raises under a mesh larger than 1x1."""
    del kind
    if not mesh_is_trivial():
        raise NotImplementedError(SHARDED_ITEM)
    return x
