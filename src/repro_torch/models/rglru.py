"""RG-LRU recurrence (recurrentgemma / Griffin, arXiv:2402.19427), in torch
(counterpart of ``repro.models.rglru``).

The Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    a_t = a^(c * r_t)                      (a = sigmoid(Lambda), c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the whole sequence with ``jax.lax.associative_scan``;
the port runs it as a sequential f32 loop over time (each step is one
elementwise update of [B, D]), which rounds differently from XLA's tree:
the reference's own oracle tolerance, 1e-4, holds between them.  Decode
is a single recurrent step carrying h.  The block wraps the RG-LRU between
a temporal conv (window 4) and a gated output projection, per the Griffin
recurrent block.

Under a mesh whose model axis divides the recurrence width, ``w_in`` /
``w_gate_in`` hold this rank's columns and ``w_out`` its rows
(``sharding.param_specs``), and the block runs on this rank's slice of
the width: the recurrence is elementwise over it.  The replicated
per-channel parameters are sliced to it (their gradients are summed over
``model``), the output projection's partial products take one psum (tag
``"rglru"``), and a decode step's new state is all-gathered back whole,
the layout ``cache_specs`` gives it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import sharding as SH
from repro_torch.models.layers import activation, einsum, truncated_normal

__all__ = ["rglru", "rglru_block", "init_rglru", "whole_state"]

_CHANNEL = ("conv_w", "w_a", "w_x", "b_a", "b_x", "lam")

_C = 8.0


def _scan_linear_recurrence(a, bx):
    """h_t = a_t * h_{t-1} + bx_t over time axis=1, from h_{-1} = 0."""
    h = torch.zeros_like(bx[:, 0])
    out = []
    for t in range(bx.shape[1]):
        h = a[:, t] * h + bx[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def rglru(p, x, h0=None):
    """x: [B, T, D] -> (y [B,T,D], h_last [B,D] f32)."""
    xf = x.float()
    r = torch.sigmoid(xf * p["w_a"] + p["b_a"])
    i = torch.sigmoid(xf * p["w_x"] + p["b_x"])
    log_a = -_C * r * F.softplus(p["lam"])          # log a_t  (a in (0,1))
    a = torch.exp(log_a)
    gated = i * xf
    bx = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) * gated
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + (a[:, 0] * h0.float())[:, None],
                        bx[:, 1:]], dim=1)
    h = _scan_linear_recurrence(a, bx)
    return h.to(x.dtype), h[:, -1]


def _conv4(ue, wconv, t):
    return sum(ue[:, i:i + t] * wconv[i] for i in range(4))


def rglru_block(p, x, positions, cfg, state=None, cache_index=None):
    """Griffin recurrent block: in-proj -> temporal conv4 -> RG-LRU -> gate
    -> out-proj.  state = (conv_tail [B,3,D'], h [B,D']) for decode."""
    del positions, cache_index
    if SH.model_split(cfg.d_model):
        return _rglru_block_sharded(p, x, cfg, state)
    return _rglru_body(p, x, state)


def _model_slice(width):
    w = width // SH.model_axis_size()
    return slice(SH.model_index() * w, (SH.model_index() + 1) * w)


def _rglru_block_sharded(p, x, cfg, state):
    """This rank's slice of the recurrence width (see the module
    docstring).  A decode step (``state`` given) returns the state whole."""
    sl = _model_slice(cfg.d_model)
    x, *chan = SH.to_model_parallel(x, *(p[n] for n in _CHANNEL),
                                    tag="rglru")
    q = {**p, **{n: c[..., sl] for n, c in zip(_CHANNEL, chan)}}
    if state is not None:
        state = tuple(s[..., sl] for s in state)
    out, new_state = _rglru_body(q, x, state)
    out = SH.from_model_parallel(out, "rglru")
    if state is not None:
        new_state = whole_state(new_state)
    return out, new_state


def whole_state(state):
    """A model-split block's (conv_tail [B,3,D'/m], h [B,D'/m]) all-gathered
    whole along the width by one collective (tag ``"rglru"``)."""
    tail, h = state
    both = SH.gather_model_parallel(
        torch.cat([tail.float(), h[:, None].float()], dim=1), -1, "rglru")
    return both[:, :3].to(tail.dtype), both[:, 3].to(h.dtype)


def _rglru_body(p, x, state):
    b, t, _ = x.shape
    u = einsum("btd,de->bte", x, p["w_in"])          # [B,T,D']
    g = einsum("btd,de->bte", x, p["w_gate_in"])

    if state is None:
        pad = torch.zeros((b, 3, u.shape[-1]), dtype=u.dtype, device=u.device)
        h0 = None
    else:
        pad, h0 = state
    ue = torch.cat([pad.to(u.dtype), u], dim=1)      # causal, window 4
    y, h_last = rglru(p, _conv4(ue, p["conv_w"], t), h0)
    y = y * activation(g, "gelu")
    return einsum("bte,ed->btd", y, p["w_out"]), (ue[:, -3:], h_last)


def init_rglru(gen, cfg, dtype, device):
    d = cfg.d_model
    dr = d                                            # recurrence width
    # Lambda init so a^c in [0.9, 0.999) as in the paper
    lo, hi = 0.9 ** 2, 0.999 ** 2
    u = torch.rand((dr,), generator=gen, dtype=torch.float32,
                   device=device) * (hi - lo) + lo
    lam = torch.log(torch.exp(-torch.log(u) / (2 * _C)) - 1.0)  # softplus^-1
    f32 = torch.float32
    return {
        "w_in": truncated_normal(gen, (d, dr), dtype, 1.0 / np.sqrt(d), device),
        "w_gate_in": truncated_normal(gen, (d, dr), dtype, 1.0 / np.sqrt(d),
                                      device),
        "w_out": truncated_normal(gen, (dr, d), dtype, 1.0 / np.sqrt(dr),
                                  device),
        "conv_w": truncated_normal(gen, (4, dr), f32, 0.5, device),
        "w_a": truncated_normal(gen, (dr,), f32, 1.0 / np.sqrt(dr), device),
        "w_x": truncated_normal(gen, (dr,), f32, 1.0 / np.sqrt(dr), device),
        "b_a": torch.zeros((dr,), dtype=f32, device=device),
        "b_x": torch.zeros((dr,), dtype=f32, device=device),
        "lam": lam,
    }

