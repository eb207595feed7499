"""Core transformer layers in torch (counterpart of ``repro.models.layers``):
plain functions over a dict of named tensors, as the reference's take a
parameter pytree, and ``Params``, the ``nn.Module`` that holds one block's
tensors as parameters (``models.model.Layer`` hands them to the
functions).

Dtypes follow the reference.  Activations are ``cfg.dtype`` (bf16) and
weights ``cfg.param_dtype`` (f32); ``jnp.einsum`` promotes bf16 x f32 to
f32, so every product that mixes them computes in f32.  ``einsum`` below
reproduces that rule (``torch.einsum`` refuses mixed dtypes).  Where the
reference casts a weight down on purpose (the tied unembedding, the MoE
experts, the frontends) the caller casts and calls ``torch.einsum``.

Under a mesh (``sharding.on_mesh()``) each rank holds its blocks of the
weights (``sharding.param_specs``) and the blocks run model-parallel:
the vocab rows of the embedding (a masked local lookup, then a psum over
``model``), the heads of attention (column-split ``wq`` / ``wk`` / ``wv``,
row-split ``wo``, one psum, tag ``"attn"``) or, where the kv heads do not
divide the model axis, its query positions against the whole K / V (tag
``"seq"``), and the columns / rows of the gated FFN (one psum, tag
``"ffn"``).
"""
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharding as SH

__all__ = ["einsum", "truncated_normal", "rmsnorm", "deterministic",
           "scatter_add_rows", "embed", "unembed",
           "embed_sharded", "unembed_sharded", "rope", "attention_mask",
           "gqa_attention", "attn_block", "activation", "ffn_block",
           "init_attn", "init_ffn", "Params"]


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


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` for the ops inside: on the
    card a float ``index_put_(accumulate=True)`` then sorts its indices
    and adds each row's terms in one fixed order, where the default adds
    them with atomics in whatever order the threads arrive (ROADMAP F2)."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def scatter_add_rows(n, index, src):
    """``[n, ...]`` zeros with row ``index[i]`` += ``src[i]``: an
    ``index_add_`` whose repeated rows add in one fixed order on the card
    too (``deterministic``)."""
    out = torch.zeros((n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    with deterministic():
        return out.index_put_((index,), src, accumulate=True)


class _Embed(torch.autograd.Function):
    """The table's rows at ``ids``; the backward adds the gradient rows of
    repeated ids in one fixed order (``scatter_add_rows``), where
    ``index_select``'s backward adds them with atomics on the card."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return scatter_add_rows(ctx.rows, ids, g), None


def embed(tokens, table):
    return _Embed.apply(table, tokens.reshape(-1)).reshape(
        *tokens.shape, table.shape[-1])


def unembed(x, table, softcap=0.0):
    logits = einsum("btd,vd->btv", x, table)
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def embed_sharded(tokens, table, vocab: int):
    """``embed`` of a table whose ``vocab`` rows may be split over
    ``model``: each rank looks up the tokens its rows hold (zeros for the
    others), and a psum over ``model`` (tag ``"embed"``) sums them."""
    if not SH.model_split(vocab):
        return embed(tokens, table)
    rows = table.shape[0]
    local = tokens - SH.model_index() * rows
    inside = (local >= 0) & (local < rows)
    x = embed(torch.where(inside, local, 0), table)
    return SH.from_model_parallel(torch.where(inside[..., None], x, 0),
                                  "embed")


def unembed_sharded(x, table, vocab: int, softcap=0.0, transposed=False):
    """The logits of a table (``[V, D]``, or ``[D, V]`` when
    ``transposed``: the untied head) whose vocab may be split over
    ``model``: this rank's vocab block, then one all-gather along the
    vocab (tag ``"logits"``), so every rank holds the whole rows.  The
    hidden states' gradient is summed over ``model`` (each rank's vocab
    block adds its share)."""
    split = SH.model_split(vocab)
    if split:
        x = SH.to_model_parallel(x, tag="logits")
    if transposed:
        logits = torch.einsum("btd,dv->btv", x, table)
    else:
        logits = unembed(x, table, softcap)
    if split:
        logits = SH.gather_model_parallel(logits, -1, "logits")
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


def _attend(q, k, v, positions, cfg, kv_cache, cache_index):
    """Attention of q over k / v, or over the cache with the new keys
    written at ``cache_index``.  Returns (out [B,T,H,hd], new_cache)."""
    if kv_cache is None:
        mask = attention_mask(positions, positions, causal=cfg.causal,
                              local_window=cfg.local_window,
                              n_prefix=cfg.n_prefix)
        return gqa_attention(q, k, v, mask), None
    ck, cv = kv_cache                           # [B, S, Kv, hd]
    s, t = ck.shape[1], q.shape[1]
    start = torch.as_tensor(cache_index, device=ck.device).clamp(0, s - t)
    rows = start.long() + torch.arange(t, device=ck.device)
    ck = ck.index_copy(1, rows, k.to(ck.dtype))
    cv = cv.index_copy(1, rows, v.to(cv.dtype))
    kv_pos = torch.arange(s, dtype=torch.int32, device=ck.device)[None]
    valid = kv_pos <= positions[:, -1:]
    mask = attention_mask(positions, kv_pos, causal=cfg.causal,
                          local_window=cfg.local_window,
                          n_prefix=cfg.n_prefix) & valid[:, None, :]
    return gqa_attention(q, ck, cv, mask), (ck, cv)


def attn_block(p, x, positions, cfg, kv_cache=None, cache_index=None):
    """Self-attention with GQA + RoPE.  If kv_cache=(k,v) is given, the new
    keys are written at ``cache_index`` (a 0-dim device tensor; the start
    is clamped so the block fits, as ``dynamic_update_slice`` does) and
    attention runs over the cache.  Returns (out, new_cache); the cache
    given is not modified."""
    if SH.on_mesh():
        return _attn_block_sharded(p, x, positions, cfg, kv_cache,
                                   cache_index)
    q, k, v = _qkv(p, x, positions, cfg.rope_theta)
    out, new_cache = _attend(q, k, v, positions, cfg, kv_cache, cache_index)
    return einsum("btnh,nhd->btd", out, p["wo"]), new_cache


def attn_weights_sharded(p, cfg):
    """The attention weights a rank computes with under a mesh: its heads'
    blocks when the kv heads divide the model axis (the heads path);
    otherwise whole, the head-split ones (``wq``, ``bq``, ``wo``, split
    when the query heads divide) gathered by one all-gather (tag
    ``"gather"``)."""
    if SH.heads_shardable(cfg.n_kv) or not SH.model_split(cfg.n_heads):
        return p
    names = [n for n in ("wq", "bq", "wo") if n in p]
    got = SH.gather_weights([p[n] for n in names],
                            [1 if n == "wq" else 0 for n in names], "gather")
    return {**p, **dict(zip(names, got))}


def _attn_block_sharded(p, x, positions, cfg, kv_cache, cache_index):
    """``attn_block`` under a mesh.  Heads path: this rank's heads (and kv
    cache heads), its partial ``wo`` product summed over ``model``.  Seq
    path (the reference's ``"btnh_seq"``): q / k / v whole on every rank,
    each model rank attends its block of query positions against the whole
    K / V, and the blocks are all-gathered along T; with a cache, or where
    T does not divide, attention runs whole on every rank."""
    if SH.heads_shardable(cfg.n_kv):
        x = SH.to_model_parallel(x, tag="attn")
        q, k, v = _qkv(p, x, positions, cfg.rope_theta)
        out, new_cache = _attend(q, k, v, positions, cfg, kv_cache,
                                 cache_index)
        out = einsum("btnh,nhd->btd", out, p["wo"])
        return SH.from_model_parallel(out, "attn"), new_cache
    p = attn_weights_sharded(p, cfg)
    q, k, v = _qkv(p, x, positions, cfg.rope_theta)
    msize, t = SH.model_axis_size(), x.shape[1]
    if kv_cache is None and t % msize == 0:
        q, k, v = SH.to_model_parallel(q, k, v, tag="seq")
        w = t // msize
        rows = slice(SH.model_index() * w, (SH.model_index() + 1) * w)
        mask = attention_mask(positions[:, rows], positions,
                              causal=cfg.causal,
                              local_window=cfg.local_window,
                              n_prefix=cfg.n_prefix)
        out = gqa_attention(q[:, rows], k, v, mask)
        out, new_cache = SH.gather_model_parallel(out, 1, "seq"), None
    else:
        out, new_cache = _attend(q, k, v, positions, cfg, kv_cache,
                                 cache_index)
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


def ffn_block(p, x, act="silu", d_ff=None):
    """The gated FFN.  Under a mesh, with ``d_ff`` (the whole width) given
    and dividing the model axis, ``w_gate`` / ``w_up`` hold this rank's
    columns and ``w_down`` its rows: the partial products are summed over
    ``model`` (tag ``"ffn"``)."""
    if d_ff is not None and SH.model_split(d_ff):
        x = SH.to_model_parallel(x, tag="ffn")
        return SH.from_model_parallel(ffn_block(p, x, act), "ffn")
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
    """One block's tensors as named parameters."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

