"""xLSTM blocks (arXiv:2405.04517) in torch (counterpart of
``repro.models.xlstm``, with the reference's adaptations).

mLSTM: matrix-memory linear attention with sigmoid gates.  The full
sequence runs in the CHUNKED recurrent form (a loop over chunks of W
tokens, default 128 as in the reference): per-chunk state ``C
[B,H,hd,hd]``, within-chunk masked attention.  Decode is one recurrent
state update.  The within-chunk decay matrix is masked before its exp:
the same values as the reference's, and a finite gradient where the
reference's is NaN (chunks of more than about 100 tokens).

sLSTM: the diagonal linear-recurrence form (gates from x_t only).  The
reference runs it with two associative scans; the port runs the same
recurrence as a sequential f32 loop over time, which rounds differently
from XLA's tree (the reference's own oracle tolerance, 1e-4, holds).

Under a mesh whose model axis divides the inner width, the rules split
both blocks' projections over ``model`` (``sharding.param_specs``), but
neither block runs on a slice of the width yet: the mLSTM's ``w_q`` /
``w_k`` / ``w_v`` / ``w_if`` mix the whole width into every head, and
the sLSTM's ``w_gates`` columns interleave the i / f / o gates across
the blocks.  Each block gathers its split weights whole by one all-gather
over ``model`` (tag ``"gather"``) and runs whole on every model rank, its
state replicated over ``model`` as ``cache_specs`` places it (ROADMAP
item 13c-iv).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import sharding as SH
from repro_torch.models.layers import einsum, f32_scalar, truncated_normal
from repro_torch.models.rglru import _scan_linear_recurrence

__all__ = ["EXPANSION", "mlstm_decode_step", "mlstm_block", "slstm_block",
           "init_mlstm", "init_slstm"]

EXPANSION = 2
# the dim of each projection that the rules split over ``model``
_SPLIT_DIM = {"w_up": 1, "w_gate": 1, "w_gates": 1, "w_q": 0, "w_k": 0,
              "w_v": 0, "w_if": 0, "w_down": 0}


def _whole(p, cfg):
    """The block's weights whole: under a mesh that splits them, gathered
    by one all-gather over ``model`` (see the module docstring)."""
    if not SH.model_split(EXPANSION * cfg.d_model):
        return p
    names = [n for n in p if n in _SPLIT_DIM]
    got = SH.gather_weights([p[n] for n in names],
                            [_SPLIT_DIM[n] for n in names], "gather")
    return {**p, **dict(zip(names, got))}


def _normalizer(n):
    """max(|n|, 1), the denominator of both cells' normaliser state (the
    sLSTM's n is positive, so |n| = n there).  It has a kink at |n| = 1:
    the gradient through it is 0 below and -1 / n**2 above, so two runs
    whose f32 values of n differ in their last digits can take different
    sides of it and give visibly different gradients from the same loss."""
    return torch.clamp_min(n.abs(), 1.0)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_chunk_scan(q, k, v, log_f, i_gate, chunk=128):
    """q,k,v: [B,H,T,hd]; log_f,i_gate: [B,H,T].  Returns y [B,H,T,hd] and
    final (C [B,H,hd,hd], n [B,H,hd])."""
    b, h, t, hd = q.shape
    w = min(chunk, t)
    nc = -(-t // w)
    pad = nc * w - t
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        log_f, i_gate = (F.pad(x, (0, pad)) for x in (log_f, i_gate))

    c = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    mask = torch.tril(torch.ones((w, w), dtype=torch.bool, device=q.device))
    ys = []
    for j in range(nc):
        sl = slice(j * w, (j + 1) * w)
        qw, kw, vw, lf, ig = q[:, :, sl], k[:, :, sl], v[:, :, sl], \
            log_f[:, :, sl], i_gate[:, :, sl]
        lcum = torch.cumsum(lf, dim=-1)                   # [B,H,W]
        ltot = lcum[..., -1:]
        # inter-chunk: state contribution decayed to each position
        dec_q = torch.exp(lcum)[..., None]                # [B,H,W,1]
        y_inter = torch.einsum("bhwd,bhde->bhwe", qw * dec_q, c)
        n_inter = torch.einsum("bhwd,bhd->bhw", qw * dec_q, n)
        # intra-chunk masked linear attention
        dmat = lcum[..., :, None] - lcum[..., None, :]    # [B,H,W,W]
        # masked before the exp, not after: above the diagonal dmat > 0
        # overflows to inf within a 128-token chunk, and the reference's
        # where(mask, exp(dmat) * ig, 0) then has a NaN gradient (0 * inf).
        # The values are the reference's.
        amat = torch.exp(dmat.masked_fill(~mask, float("-inf"))) \
            * ig[..., None, :]
        smat = torch.einsum("bhwd,bhsd->bhws", qw, kw) * amat
        y_intra = torch.einsum("bhws,bhsd->bhwd", smat, vw)
        n_intra = smat.sum(dim=-1)
        nn_ = n_inter + n_intra
        ys.append((y_inter + y_intra)
                  / _normalizer(nn_)[..., None])
        # state update
        kd = kw * torch.exp(ltot - lcum)[..., None] * ig[..., None]
        c = torch.exp(ltot)[..., None] * c + torch.einsum(
            "bhwd,bhwe->bhde", kd, vw)
        n = torch.exp(ltot) * n + kd.sum(dim=2)
    y = torch.cat(ys, dim=2)[:, :, :t]
    return y, (c, n)


def mlstm_decode_step(q, k, v, log_f, i_gate, state):
    """Single-token recurrent update.  q,k,v: [B,H,1,hd]."""
    c, n = state
    f = torch.exp(log_f[:, :, 0])                         # [B,H]
    ki = k * i_gate[..., None]
    c = f[..., None, None] * c + torch.einsum("bhtd,bhte->bhde", ki, v)
    n = f[..., None] * n + ki[:, :, 0]
    y = torch.einsum("bhtd,bhde->bhte", q, c)
    nn_ = torch.einsum("bhtd,bhd->bht", q, n)
    return y / _normalizer(nn_)[..., None], (c, n)


def mlstm_block(p, x, positions, cfg, state=None, cache_index=None):
    """Pre-norm handled by caller.  x: [B,T,D]."""
    del positions, cache_index
    p = _whole(p, cfg)
    b, t, d = x.shape
    h = cfg.n_heads
    di = EXPANSION * d
    hd = di // h
    u = einsum("btd,de->bte", x, p["w_up"])
    g = einsum("btd,de->bte", x, p["w_gate"])

    def spl(w):
        return einsum("bte,ef->btf", u, w).reshape(b, t, h, hd).transpose(1, 2)

    q, k, v = spl(p["w_q"]), spl(p["w_k"]), spl(p["w_v"])
    k = k / f32_scalar(np.sqrt(hd))
    gates = einsum("bte,ef->btf", u, p["w_if"])           # [B,T,2H]
    i_gate = torch.sigmoid(gates[..., :h]).transpose(1, 2).float()
    log_f = F.logsigmoid(gates[..., h:]).transpose(1, 2).float()
    qf, kf, vf = (z.float() for z in (q, k, v))
    if state is None:
        y, new_state = _mlstm_chunk_scan(qf, kf, vf, log_f, i_gate)
    else:
        y, new_state = mlstm_decode_step(qf, kf, vf, log_f, i_gate, state)
    y = y.transpose(1, 2).reshape(b, t, di).to(x.dtype)
    y = y * F.silu(g)
    return einsum("bte,ed->btd", y, p["w_down"]), new_state


def init_mlstm(gen, cfg, dtype, device):
    d = cfg.d_model
    di = EXPANSION * d
    sc = 1.0 / np.sqrt(d)
    sci = 1.0 / np.sqrt(di)
    return {
        "w_up": truncated_normal(gen, (d, di), dtype, sc, device),
        "w_gate": truncated_normal(gen, (d, di), dtype, sc, device),
        "w_q": truncated_normal(gen, (di, di), dtype, sci, device),
        "w_k": truncated_normal(gen, (di, di), dtype, sci, device),
        "w_v": truncated_normal(gen, (di, di), dtype, sci, device),
        "w_if": truncated_normal(gen, (di, 2 * cfg.n_heads), torch.float32,
                                 sci, device),
        "w_down": truncated_normal(gen, (di, d), dtype, sci, device),
    }


# ---------------------------------------------------------------------------
# sLSTM (diagonal linear-recurrence form)
# ---------------------------------------------------------------------------

def slstm_block(p, x, positions, cfg, state=None, cache_index=None):
    del positions, cache_index
    p = _whole(p, cfg)
    di = EXPANSION * x.shape[-1]
    u = einsum("btd,de->bte", x, p["w_up"]).float()
    gates = einsum("btd,dg->btg", x, p["w_gates"]).float()
    i = torch.sigmoid(gates[..., :di])
    f = torch.sigmoid(gates[..., di:2 * di] + 1.0)        # forget bias +1
    o = torch.sigmoid(gates[..., 2 * di:3 * di])
    z = torch.tanh(u)
    if state is None:
        c = _scan_linear_recurrence(f, i * z)
        n = _scan_linear_recurrence(f, i)
    else:
        c0, n0 = state
        c = (f[:, 0] * c0 + i[:, 0] * z[:, 0])[:, None]
        n = (f[:, 0] * n0 + i[:, 0])[:, None]
    hh = o * c / _normalizer(n)
    return (einsum("bte,ed->btd", hh.to(x.dtype), p["w_down"]),
            (c[:, -1], n[:, -1]))


def init_slstm(gen, cfg, dtype, device):
    d = cfg.d_model
    di = EXPANSION * d
    return {
        "w_up": truncated_normal(gen, (d, di), dtype, 1.0 / np.sqrt(d), device),
        "w_gates": truncated_normal(gen, (d, 3 * di), dtype, 1.0 / np.sqrt(d),
                                    device),
        "w_down": truncated_normal(gen, (di, d), dtype, 1.0 / np.sqrt(di),
                                   device),
    }

