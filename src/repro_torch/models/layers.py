"""Core transformer layers in torch (counterpart of ``repro.models.layers``):
plain functions over a dict of named tensors, as the reference's take a
parameter pytree, and one ``nn.Module`` per block kind that holds those
tensors as parameters and calls its function.

Dtypes follow the reference.  Activations are ``cfg.dtype`` (bf16) and
weights ``cfg.param_dtype`` (f32); ``jnp.einsum`` promotes bf16 x f32 to
f32, so every product that mixes them computes in f32.  ``einsum`` below
reproduces that rule (``torch.einsum`` refuses mixed dtypes).  Where the
reference casts a weight down on purpose (the tied unembedding, the MoE
experts, the frontends) the caller casts and calls ``torch.einsum``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.sharding import constrain_act, heads_shardable

__all__ = ["einsum", "truncated_normal", "rmsnorm", "embed", "unembed",
           "rope", "attention_mask", "gqa_attention", "attn_block",
           "activation", "ffn_block", "init_attn", "init_ffn", "Params",
           "AttnBlock", "FFN"]


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's promotion of mixed float operands: all
    operands are cast to their promoted dtype first (bf16 x f32 -> f32)."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def f32_scalar(v: float) -> float:
    """``v`` rounded to f32, as the reference's ``np.float32`` constants."""
    return float(np.float32(v))


def truncated_normal(gen: torch.Generator, shape, dtype, scale, device):
    """``jax.nn.initializers.truncated_normal(scale)``: a standard normal
    cut at +-2, times ``scale`` (no variance correction: the draw's std is
    0.8796 * scale, as the reference's).  Drawn in place on ``device`` from
    ``gen``."""
    t = torch.empty(shape, dtype=dtype, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale)


# ---------------------------------------------------------------------------
# norms / embeddings / rope
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def embed(tokens, table):
    return table.index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, table.shape[-1])


def unembed(x, table, softcap=0.0):
    logits = einsum("btd,vd->btv", x, table)
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def rope(x, positions, theta=10_000.0):
    """x: [..., T, n, head_dim]; positions: [..., T]."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq               # [...,T,half]
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional local window / non-causal / prefix bidirectional)
# ---------------------------------------------------------------------------

def attention_mask(q_pos, kv_pos, *, causal=True, local_window=0, n_prefix=0):
    """[..., Tq, Tk] boolean mask.  n_prefix: bidirectional prefix (vlm)."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                   device=q.device)
    if causal:
        cm = k <= q
        if n_prefix:
            cm = cm | ((k < n_prefix) & (q < n_prefix))
        m = m & cm
    if local_window:
        m = m & (k > q - local_window)
    return m


def gqa_attention(q, k, v, mask):
    """q: [B,T,H,hd]; k/v: [B,S,Kv,hd]; mask: [B,T,S] boolean.  Masked
    logits are filled with -1e30 in f32, as in the reference."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(b, t, kv, h // kv, hd)
    logits = einsum("btkgh,bskh->bkgts", q, k).float()
    logits = logits / f32_scalar(math.sqrt(hd))
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = einsum("bkgts,bskh->btkgh", w, v)
    return out.reshape(b, t, h, hd)


def _qkv(p, x, positions, theta):
    q = einsum("btd,dnh->btnh", x, p["wq"])
    k = einsum("btd,dnh->btnh", x, p["wk"])
    v = einsum("btd,dnh->btnh", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return rope(q, positions, theta), rope(k, positions, theta), v


def attn_block(p, x, positions, cfg, kv_cache=None, cache_index=None):
    """Self-attention with GQA + RoPE.  If kv_cache=(k,v) is given, the new
    keys are written at ``cache_index`` (a 0-dim device tensor; the start
    is clamped so the block fits, as ``dynamic_update_slice`` does) and
    attention runs over the cache.  Returns (out, new_cache); the cache
    given is not modified."""
    q, k, v = _qkv(p, x, positions, cfg.rope_theta)
    if kv_cache is None:
        if not heads_shardable(cfg.n_kv):
            q = constrain_act(q, "btnh_seq")
        mask = attention_mask(positions, positions, causal=cfg.causal,
                              local_window=cfg.local_window,
                              n_prefix=cfg.n_prefix)
        out = gqa_attention(q, k, v, mask)
        if not heads_shardable(cfg.n_kv):
            out = constrain_act(out, "btnh_seq")
        new_cache = None
    else:
        ck, cv = kv_cache                       # [B, S, Kv, hd]
        s, t = ck.shape[1], x.shape[1]
        start = torch.as_tensor(cache_index, device=ck.device).clamp(0, s - t)
        rows = start.long() + torch.arange(t, device=ck.device)
        ck = ck.index_copy(1, rows, k.to(ck.dtype))
        cv = cv.index_copy(1, rows, v.to(cv.dtype))
        kv_pos = torch.arange(s, dtype=torch.int32, device=ck.device)[None]
        valid = kv_pos <= positions[:, -1:]
        mask = attention_mask(positions, kv_pos, causal=cfg.causal,
                              local_window=cfg.local_window,
                              n_prefix=cfg.n_prefix) & valid[:, None, :]
        out = gqa_attention(q, ck, cv, mask)
        new_cache = (ck, cv)
    return einsum("btnh,nhd->btd", out, p["wo"]), new_cache


def init_attn(gen, cfg, dtype, device):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    sc = 1.0 / np.sqrt(d)
    p = {
        "wq": truncated_normal(gen, (d, h, hd), dtype, sc, device),
        "wk": truncated_normal(gen, (d, kv, hd), dtype, sc, device),
        "wv": truncated_normal(gen, (d, kv, hd), dtype, sc, device),
        "wo": truncated_normal(gen, (h, hd, d), dtype, 1.0 / np.sqrt(h * hd),
                               device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# gated feed-forward (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def activation(x, act):
    """``jax.nn.silu`` or ``jax.nn.gelu`` (its default tanh approximation).
    silu is written out as the reference computes it: x * logistic(x), with
    XLA's expansion of the logistic, 1 / (1 + exp(-x)), each operation in
    the operand's dtype.  In bf16 (the MoE's experts) torch's fused silu
    rounds once instead and differs in about a third of the values."""
    if act == "silu":
        return x * (1 / (1 + torch.exp(-x)))
    return F.gelu(x, approximate="tanh")


def ffn_block(p, x, act="silu"):
    gate = einsum("btd,df->btf", x, p["w_gate"])
    up = einsum("btd,df->btf", x, p["w_up"])
    return einsum("btf,fd->btd", activation(gate, act) * up, p["w_down"])


def init_ffn(gen, d, f, dtype, device):
    return {
        "w_gate": truncated_normal(gen, (d, f), dtype, 1.0 / np.sqrt(d), device),
        "w_up": truncated_normal(gen, (d, f), dtype, 1.0 / np.sqrt(d), device),
        "w_down": truncated_normal(gen, (f, d), dtype, 1.0 / np.sqrt(f), device),
    }


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Params(nn.Module):
    """One block's tensors as named parameters; ``p()`` hands them to the
    block's function as the dict the reference's functions take."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    def p(self) -> dict:
        return dict(self._parameters)


class AttnBlock(Params):
    def forward(self, x, positions, cfg, state=None, cache_index=None):
        return attn_block(self.p(), x, positions, cfg, state, cache_index)


class FFN(Params):
    def forward(self, x, act):
        return ffn_block(self.p(), x, act)
