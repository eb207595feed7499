"""Mixture-of-Experts with capacity-bounded gather dispatch, in torch
(counterpart of ``repro.models.moe``'s plain path).

Routing: top-k per token; each expert then takes its top-``capacity``
tokens by router weight (GShard-style token dropping, dropped tokens fall
through on the residual path).  Dispatch is gather/scatter, not an
[N, E, C] one-hot einsum.

``jax.lax.top_k`` breaks ties toward the lower index and ``torch.topk``
promises no order, so both top-k picks here are a stable descending sort
cut at k: which tokens fill an expert's capacity, and which are dropped,
are the reference's.

The reference's two mesh paths (``_moe_a2a_experts``, ``_moe_local_experts``)
are ROADMAP item 13c: under a mesh larger than 1x1, ``moe_block`` raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models import sharding as SH
from repro_torch.models.layers import (Params, activation, ffn_block, init_ffn,
                                       truncated_normal)
from repro_torch.models.sharding import constrain_act

__all__ = ["moe_block", "init_moe", "MoE"]


def _top_k(x, k):
    """(values, indices) of the k largest along the last axis, descending,
    ties to the lower index (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _route_and_gather(xf, router, e, k, cap):
    """Shared routing: top-k per token -> per-expert top-cap tokens.
    Returns (gw [E,cap] combine weights, gi [E,cap] token ids)."""
    n = xf.shape[0]
    # the product of xf and the router cast to xf's dtype, kept in f32: the
    # reference's product feeds an f32 softmax, and under jit XLA drops its
    # rounding to the activation dtype (bf16) in between
    logits = torch.einsum("nd,de->ne", xf.float(), router.to(xf.dtype).float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    smat = torch.zeros((e, n), dtype=torch.float32, device=xf.device)
    cols = torch.arange(n, device=xf.device)[None].expand(k, n)
    smat.index_put_((top_i.T, cols), top_w.T)
    return _top_k(smat, cap)


def _expert_ffn(xe, w_gate, w_up, w_down, act):
    gate = torch.einsum("ecd,edf->ecf", xe, w_gate)
    up = torch.einsum("ecd,edf->ecf", xe, w_up)
    return torch.einsum("ecf,efd->ecd", activation(gate, act) * up, w_down)


def moe_block(p, x, cfg):
    """x: [B, T, D] -> [B, T, D].

    The plain path, under no mesh or a 1x1 mesh.  On a one-device mesh the
    reference enters its ``shard_map`` path, whose only collective is a
    psum over a model axis of size 1: the same function as its plain path
    (``tests/test_moe_sharded.py`` holds the two equal), so the port runs
    the plain path there.  A larger mesh raises: the mesh paths are ROADMAP
    item 13c, and no run takes the plain path in their place."""
    if not SH.mesh_is_trivial():
        raise NotImplementedError(
            "moe_block under a mesh larger than 1x1: the MoE mesh paths "
            "(_moe_a2a_experts, _moe_local_experts) are ROADMAP item 13c")
    return _moe_block_plain(p, x, cfg)


def _moe_block_plain(p, x, cfg):
    """The reference's ``_moe_block_jnp``: capacity-bounded gather dispatch.
    The expert weights are cast to the activation dtype, as there."""
    b, t, d = x.shape
    n = b * t
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(n, d)

    cap = math.ceil(k * n / e * cfg.moe_capacity_factor)
    cap = min(max(8, cap), n)
    gw, gi = _route_and_gather(xf, p["router"], e, k, cap)  # [E, cap]

    xe = xf.index_select(0, gi.reshape(-1)).reshape(e, cap, d)
    xe = constrain_act(xe, "ecd")

    ye = _expert_ffn(xe, p["w_gate"].to(x.dtype), p["w_up"].to(x.dtype),
                     p["w_down"].to(x.dtype), cfg.act)
    ye = ye * (gw > 0)[..., None].to(ye.dtype)
    ye = ye * gw[..., None].to(ye.dtype)
    ye = constrain_act(ye, "ecd")

    out = torch.zeros((n, d), dtype=ye.dtype, device=x.device)
    out.index_add_(0, gi.reshape(-1), ye.reshape(-1, d))    # combine
    out = constrain_act(out.reshape(b, t, d), "btd")

    if cfg.moe_dense_residual:
        out = out + ffn_block({k_: p[f"res_{k_}"] for k_ in
                               ("w_gate", "w_up", "w_down")}, x, cfg.act)
    return out


def init_moe(gen, cfg, dtype, device):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": truncated_normal(gen, (d, e), torch.float32, 1.0 / np.sqrt(d),
                                   device),
        "w_gate": truncated_normal(gen, (e, d, f), dtype, 1.0 / np.sqrt(d),
                                   device),
        "w_up": truncated_normal(gen, (e, d, f), dtype, 1.0 / np.sqrt(d),
                                 device),
        "w_down": truncated_normal(gen, (e, f, d), dtype, 1.0 / np.sqrt(f),
                                   device),
    }
    if cfg.moe_dense_residual:
        res = init_ffn(gen, d, cfg.moe_dense_ff or f, dtype, device)
        p.update({f"res_{k}": v for k, v in res.items()})
    return p


class MoE(Params):
    def forward(self, x, cfg):
        return moe_block(self.p(), x, cfg)
