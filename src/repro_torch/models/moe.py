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

Under a mesh whose model axis divides the experts, ``moe_block`` runs the
reference's two ``shard_map`` bodies on this rank's ``E / m`` experts
(``sharding.param_specs`` puts experts on ``model``):

  * ``_moe_local_experts``: identical routing on every model rank over
    the rank's data block, the rank's experts' tokens, and one psum over
    ``model`` of the partial combines (tag ``"moe"``);
  * ``_moe_a2a_experts``: the tokens also sliced over ``model``, each
    slice routed by its rank (capacity from the slice, floor 4), two
    all-to-alls of ``[e_loc, cap, d]`` blocks to the experts' owners and
    back, the combine, and one tiled all-gather (tag ``"moe"``).

The a2a path runs when the data block's tokens split evenly over
``model`` with at least 64 a rank, the local path otherwise, the plain
path under no mesh or when the experts do not divide the model axis.
The reference also takes its plain path when the global batch does not
divide the data axes; the port's rank sees only its data block, so there
it takes the local path, the same function on a replicated batch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models import sharding as SH
from repro_torch.models.layers import (activation, ffn_block, init_ffn,
                                       scatter_add_rows, truncated_normal)

__all__ = ["moe_block", "init_moe"]


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
    """x: [B, T, D] -> [B, T, D] (this rank's data block under a mesh).
    The expert weights are cast to the activation dtype, as in the
    reference."""
    if not SH.model_split(cfg.n_experts):
        return _moe_block_plain(p, x, cfg)
    msize = SH.model_axis_size()
    n_loc = x.shape[0] * x.shape[1]
    impl = (_moe_a2a_experts if n_loc % msize == 0 and n_loc // msize >= 64
            else _moe_local_experts)
    out = impl(x, p["router"], p["w_gate"].to(x.dtype),
               p["w_up"].to(x.dtype), p["w_down"].to(x.dtype), cfg=cfg)
    if cfg.moe_dense_residual:
        out = out + _residual(p, x, cfg)
    return out


def _residual(p, x, cfg):
    return ffn_block({k_: p[f"res_{k_}"] for k_ in
                      ("w_gate", "w_up", "w_down")}, x, cfg.act,
                     d_ff=cfg.moe_dense_ff or cfg.d_ff)


def _combine(ye, gw, gi, n):
    """The experts' outputs weighted and scattered back to their tokens:
    ``[E', cap, d]`` -> ``[n, d]``."""
    ye = ye * (gw > 0)[..., None].to(ye.dtype)
    ye = ye * gw[..., None].to(ye.dtype)
    return scatter_add_rows(n, gi.reshape(-1), ye.reshape(-1, ye.shape[-1]))


def _moe_local_experts(x, router, w_gate, w_up, w_down, *, cfg):
    """Every model rank routes the whole data block alike and runs its
    own experts' tokens; the partial combines are one psum over
    ``model``.  The routing is the replicated part: the rank-dependent
    work starts at the tokens and combine weights (their gradients are
    summed over ``model``)."""
    b, t, d = x.shape
    n = b * t
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // SH.model_axis_size()
    xf = x.reshape(n, d)
    cap = math.ceil(k * n / e * cfg.moe_capacity_factor)
    cap = min(max(8, cap), n)
    gw, gi = _route_and_gather(xf, router, e, k, cap)
    xf, gw = SH.to_model_parallel(xf, gw, tag="moe")
    mine = slice(SH.model_index() * e_loc, (SH.model_index() + 1) * e_loc)
    gw_l, gi_l = gw[mine], gi[mine]
    xe = xf.index_select(0, gi_l.reshape(-1)).reshape(e_loc, cap, d)
    ye = _expert_ffn(xe, w_gate, w_up, w_down, cfg.act)
    out = SH.from_model_parallel(_combine(ye, gw_l, gi_l, n), "moe")
    return out.reshape(b, t, d)


def _moe_a2a_experts(x, router, w_gate, w_up, w_down, *, cfg):
    """The tokens of the data block sliced over ``model``: each rank routes
    its slice (capacity from the slice, floor 4), one all-to-all ships
    each expert's ``[e_loc, cap, d]`` block to its owner, the owner runs
    its experts on the blocks of every source, the reverse all-to-all
    returns them, and the combined slices are all-gathered (tiled).  The
    router is replicated and each rank uses it on other tokens: its
    gradient, and the tokens', are summed over ``model``."""
    b, t, d = x.shape
    n = b * t
    e, k = cfg.n_experts, cfg.top_k
    msize = SH.model_axis_size()
    e_loc = e // msize
    n_loc = n // msize
    xf, router = SH.to_model_parallel(x.reshape(n, d), router, tag="moe")
    r = SH.model_index()
    xme = xf[r * n_loc:(r + 1) * n_loc]
    cap = math.ceil(k * n_loc / e * cfg.moe_capacity_factor)
    cap = min(max(4, cap), n_loc)
    gw, gi = _route_and_gather(xme, router, e, k, cap)      # [E, cap]
    xe = xme.index_select(0, gi.reshape(-1)).reshape(e, cap, d)
    # dispatch: block s (experts of rank s) to rank s; back come the
    # blocks [source, e_loc, cap, d] of this rank's experts
    xe = SH.all_to_all_model(xe, "moe")
    xe = xe.reshape(msize, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, msize * cap, d)
    ye = _expert_ffn(xe, w_gate, w_up, w_down, cfg.act)
    ye = ye.reshape(e_loc, msize, cap, d).transpose(0, 1).reshape(e, cap, d)
    ye = SH.all_to_all_model(ye, "moe")                     # my tokens back
    out = _combine(ye, gw, gi, n_loc)
    out = SH.gather_model_parallel(out, 0, "moe")           # [N, D]
    return out.reshape(b, t, d)


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
    ye = _expert_ffn(xe, p["w_gate"].to(x.dtype), p["w_up"].to(x.dtype),
                     p["w_down"].to(x.dtype), cfg.act)
    out = _combine(ye, gw, gi, n).reshape(b, t, d)
    if cfg.moe_dense_residual:
        out = out + _residual(p, x, cfg)
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

