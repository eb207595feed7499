"""Mesh construction for the LM launchers (counterpart of
``repro.launch.mesh``), over ``torch.distributed``'s ``DeviceMesh`` -- the
mesh type of ``core/collectives.py``.

A ``DeviceMesh`` needs a process group, one process per card.  Where none
exists, as in ``launch/serve.py``, which starts none, ``make_smoke_mesh``
returns ``None`` and the model runs under no mesh (the plain path).
"""
from __future__ import annotations

import math

import torch.distributed as tdist

from repro_torch.models.sharding import MeshAxes

__all__ = ["make_production_mesh", "make_smoke_mesh", "mesh_axes"]


def _world() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks; 2x16x16 = 512 across two pods.  Raises unless
    the process group has exactly that many ranks (the reference's
    ``jax.make_mesh`` fails with fewer devices too)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if _world() != need:
        raise RuntimeError(f"the production mesh {shape} needs {need} ranks, "
                           f"one per card; this process has {_world()}")
    return _mesh(shape, names)


def mesh_axes(mesh) -> MeshAxes | None:
    """Logical-axis view of a mesh for the sharding rules (None: no mesh)."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names
    return MeshAxes(data=tuple(n for n in names if n != "model"),
                    model="model",
                    sizes={n: mesh.size(i) for i, n in enumerate(names)})


def make_smoke_mesh():
    """A (1, world) ("data", "model") mesh over the process group, or None
    where no process group exists."""
    if not tdist.is_initialized():
        return None
    return _mesh((1, _world()), ("data", "model"))
