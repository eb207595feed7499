"""AdamW written by hand (counterpart of ``repro.train.optimizer``).

The state is the port's own: ``m`` and ``v`` are dicts {parameter name:
tensor} in ``opt_dtype`` (f32, or bf16 for the MoE giants), ``step`` a
0-dim int32 tensor on the parameters' device.  The update math is f32
whatever the moments' dtype; the bias corrections come from the device
step, the decay is added to the Adam direction before the learning rate,
and each result is cast back to its tensor's dtype.  This is not
``torch.optim.AdamW``, which decays as ``p *= 1 - lr * wd`` and keeps its
moments in the parameter's dtype.  Nothing here reads a value back to
the host.

The update goes one tensor at a time, in place, so its f32 temporaries
are never larger than the largest tensor's.
"""
from __future__ import annotations

import torch

__all__ = ["adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm"]


def adamw_init(params: dict, opt_dtype=torch.float32) -> dict:
    """Zero moments for ``params`` ({name: tensor}) and step 0."""
    dev = next(iter(params.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=opt_dtype, device=dev)  # noqa: E731
    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads: dict, opt: dict, params: dict, *, lr, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step, written into ``params`` and ``opt`` in place (the
    reference returns new trees).  ``grads``, ``params`` and ``opt["m"]`` /
    ``opt["v"]`` are dicts keyed alike.  Returns ``(params, opt)``."""
    step = opt["step"] + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for name, p in params.items():
        g32 = grads[name].float()
        m, v = opt["m"][name], opt["v"][name]
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + g32 * (1 - b2) * g32
        delta = (m32 / bc1) / ((v32 / bc2).sqrt() + eps)
        delta = delta + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    opt["step"] = step
    return params, opt


def global_norm(grads: dict, specs: dict | None = None) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32, on the device.
    With ``specs`` ({name: spec}, under a mesh: the gradients are blocks)
    each block's sum of squares is summed over the mesh, counted only on
    the ranks at index 0 of every axis that does not split it: one psum
    over the mesh axes of the vector of sums (tag ``"norm"``)."""
    sums = [g.float().square().sum() for g in grads.values()]
    if specs is not None:
        from repro_torch.models import sharding as SH
        comm = SH.COMM
        names = comm.mesh.mesh_dim_names
        for i, n in enumerate(grads):
            split = set(SH.spec_axes(specs[n]))
            if any(comm.axis_index(a) for a in names if a not in split):
                sums[i] = torch.zeros_like(sums[i])
        return comm.psum(torch.stack(sums), names, "norm").sum().sqrt()
    return torch.stack(sums).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm, specs: dict | None = None):
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))`` (the
    scale stays on the device; f32 math, cast back to each gradient's
    dtype).  ``specs``: see ``global_norm``.  Returns ``(clipped grads,
    norm)``."""
    norm = global_norm(grads, specs)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype)
            for n, g in grads.items()}, norm
