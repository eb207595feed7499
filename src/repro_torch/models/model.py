"""Composable LM in torch (counterpart of ``repro.models.model``).

``LM`` is an ``nn.Module`` with one ``Layer`` per layer in an
``nn.ModuleList``: layer ``l`` runs block kind ``cfg.block_kind(l)``
(attn: GQA + RoPE, optional local window / bidirectional prefix; rglru:
the Griffin recurrent block; mlstm / slstm: xLSTM), then, when
``d_ff > 0``, a dense gated FFN or an MoE.  The reference stacks layers per
pattern position and scans them; ``params_from_numpy`` maps its pytree
onto this layout (group ``g`` at pattern position ``p`` is layer
``g * len(pattern) + p``, remainder ``i`` is layer
``n_groups * len(pattern) + i``), and ``cache_to_numpy`` /
``cache_from_numpy`` do the same for the decode cache.

Modality frontends are stubs, as in the reference: hubert consumes
precomputed frame embeddings, paligemma precomputed patch embeddings,
each projected by one learned matrix.

The residual stream is kept in ``cfg.dtype``; every product of a bf16
activation with an f32 weight runs in f32 (``layers.einsum``), and the
gemma family's ``sqrt(d_model)`` scale is applied in f32, then cast.
``decode_step`` writes the attention ring buffers in place (``index_copy_``
at ``index % S`` on a device index) and returns the same cache dict with
the recurrent states replaced and ``index`` advanced: no step reads a value
back to the host.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import constrain_act

__all__ = ["LM", "Layer", "init_params", "forward", "init_cache",
           "decode_step", "params_from_numpy", "cache_from_numpy",
           "cache_to_numpy"]

BLOCKS = {
    "attn": L.AttnBlock,
    "rglru": RG.RGLRUBlock,
    "mlstm": XL.MLSTMBlock,
    "slstm": XL.SLSTMBlock,
}
BLOCK_INIT = {
    "attn": L.init_attn,
    "rglru": RG.init_rglru,
    "mlstm": XL.init_mlstm,
    "slstm": XL.init_slstm,
}


def _dt(name):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _gemma_scale(cfg) -> float | None:
    if cfg.name.startswith(("gemma", "recurrentgemma", "paligemma")):
        return L.f32_scalar(np.sqrt(cfg.d_model))
    return None


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One layer: pre-norm block of its kind, then pre-norm FFN or MoE.
    ``tree`` is the reference's per-layer dict (``kind_params``, ``norm1``,
    and ``norm2`` with ``ffn`` or ``moe`` when ``d_ff > 0``)."""

    def __init__(self, cfg: ModelConfig, layer: int, tree: dict):
        super().__init__()
        self.kind = cfg.block_kind(layer)
        self.kind_params = BLOCKS[self.kind](tree["kind_params"])
        self.norm1 = nn.Parameter(tree["norm1"])
        self.norm2 = nn.Parameter(tree["norm2"]) if "norm2" in tree else None
        self.ffn = L.FFN(tree["ffn"]) if "ffn" in tree else None
        self.moe = MOE.MoE(tree["moe"]) if "moe" in tree else None

    def forward(self, x, positions, cfg, state=None, index=None,
                decode=False):
        dt = x.dtype                  # keep the residual stream in cfg.dtype
        h = L.rmsnorm(x, self.norm1)
        if decode and self.kind == "attn":
            out, new_state = _attn_decode(cfg, self.kind_params.p(), h,
                                          positions, state, index)
        else:
            out, new_state = self.kind_params(h, positions, cfg, state, index)
        x = (x + out).to(dt)
        if cfg.d_ff > 0:
            h = L.rmsnorm(x, self.norm2)
            out = self.moe(h, cfg) if self.moe is not None else self.ffn(h, cfg.act)
            x = (x + out).to(dt)
        return x, new_state


class LM(nn.Module):
    """The model: embedding (tied head for decoders), optional frontend
    projection, optional untied head (encoders), the layers, final norm."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = nn.Parameter(tree["final_norm"])
        self.frontend_proj = (nn.Parameter(tree["frontend_proj"])
                              if "frontend_proj" in tree else None)
        self.head = nn.Parameter(tree["head"]) if "head" in tree else None
        self.layers = nn.ModuleList(Layer(cfg, l, t)
                                    for l, t in enumerate(tree["layers"]))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, batch, **kw):
        return forward(self, batch, **kw)


# ---------------------------------------------------------------------------
# init and the weights carried across
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, layer: int, dtype, device):
    p = {"kind_params": BLOCK_INIT[cfg.block_kind(layer)](gen, cfg, dtype,
                                                          device),
         "norm1": torch.zeros((cfg.d_model,), dtype=torch.float32,
                              device=device)}
    if cfg.d_ff > 0:
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                 device=device)
        if cfg.is_moe_layer(layer):
            p["moe"] = MOE.init_moe(gen, cfg, dtype, device)
        else:
            p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> LM:
    """A model with the reference's initial distributions, drawn on
    ``device`` (``None`` means CUDA) from ``generator`` (a generator on that
    device; ``None`` means one seeded with 0).  The draws are not the
    reference's bits: ``params_from_numpy`` carries its weights across."""
    dev = resolve_device(device)
    for l in range(cfg.n_layers):
        if cfg.is_moe_layer(l) != cfg.is_moe_layer(l % len(cfg.pattern)):
            raise ValueError("MoE periodicity must align with the layer "
                             "pattern")
    gen = (generator if generator is not None
           else torch.Generator(device=dev).manual_seed(0))
    dtype = _dt(cfg.param_dtype)
    tree = {
        "embed": L.truncated_normal(gen, (cfg.vocab, cfg.d_model), dtype,
                                    cfg.d_model ** -0.5, dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=dev),
    }
    if cfg.frontend != "none":
        tree["frontend_proj"] = L.truncated_normal(
            gen, (cfg.frontend_dim, cfg.d_model), dtype,
            1.0 / np.sqrt(cfg.frontend_dim), dev)
    if not cfg.causal:            # encoder: untied classification head
        tree["head"] = L.truncated_normal(
            gen, (cfg.d_model, cfg.vocab), dtype, 1.0 / np.sqrt(cfg.d_model),
            dev)
    tree["layers"] = [_init_layer(gen, cfg, l, dtype, dev)
                      for l in range(cfg.n_layers)]
    return LM(cfg, tree)


def _to_torch(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor; a bfloat16 leaf (ml_dtypes) stays bf16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _layer_of(cfg: ModelConfig, g: int, p: int) -> int:
    return g * len(cfg.pattern) + p


def _unstack(cfg: ModelConfig, tree: dict) -> list:
    """The reference's ``groups`` / ``remainder`` layout -> one entry per
    layer, in layer order."""
    out = [None] * cfg.n_layers
    for p, gp in enumerate(tree["groups"]):
        for g in range(cfg.n_groups):
            out[_layer_of(cfg, g, p)] = _map(gp, lambda a, g=g: a[g])
    base = cfg.n_groups * len(cfg.pattern)
    for i, rp in enumerate(tree["remainder"]):
        out[base + i] = rp
    return out


def _stack(cfg: ModelConfig, per_layer: list) -> tuple:
    """One entry per layer -> the reference's (groups, remainder)."""
    def zip_map(trees):
        t0 = trees[0]
        if isinstance(t0, dict):
            return {k: zip_map([t[k] for t in trees]) for k in t0}
        if isinstance(t0, (list, tuple)):
            return type(t0)(zip_map([t[i] for t in trees])
                            for i in range(len(t0)))
        return np.stack(trees)

    groups = [zip_map([per_layer[_layer_of(cfg, g, p)]
                       for g in range(cfg.n_groups)])
              for p in range(len(cfg.pattern))]
    base = cfg.n_groups * len(cfg.pattern)
    return groups, per_layer[base:]


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """The reference's parameter pytree (every leaf a numpy array) as the
    port's ``LM`` on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    conv = lambda a: _to_torch(a, dev)  # noqa: E731
    flat = {k: conv(v) for k, v in tree.items()
            if k not in ("groups", "remainder")}
    flat["layers"] = [_map(t, conv) for t in _unstack(cfg, tree)]
    return LM(cfg, flat)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed_inputs(model: LM, cfg: ModelConfig, batch):
    dtype = _dt(cfg.dtype)
    parts = []
    if cfg.frontend == "audio_frames":
        parts.append(torch.einsum("btf,fd->btd", batch["frames"].to(dtype),
                                  model.frontend_proj.to(dtype)))
    elif cfg.frontend == "vision_patches":
        parts.append(torch.einsum("bpf,fd->bpd", batch["patches"].to(dtype),
                                  model.frontend_proj.to(dtype)))
    if "tokens" in batch and cfg.frontend != "audio_frames":
        parts.append(L.embed(batch["tokens"], model.embed).to(dtype))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    scale = _gemma_scale(cfg)
    if scale is not None:
        x = x.float() * scale
    return x.to(dtype)


def forward(model: LM, batch, *, return_states=False, return_hidden=False):
    """Full-sequence forward (training / prefill) over a batch of tensors
    on the model's device (``tokens`` [B,T] int; ``frames`` [B,T,F] for the
    audio frontend; ``patches`` [B,P,F] for the vision prefix).  Returns
    logits [B, T, vocab] (and the per-layer states, in layer order, if
    return_states); with return_hidden, the pre-unembed hidden states
    [B, T, D] instead."""
    cfg = model.cfg
    x = constrain_act(_embed_inputs(model, cfg, batch), "btd")
    b, t, _ = x.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=x.device)[None].expand(b, t)
    states = []
    for layer in model.layers:
        x, st = layer(x, positions, cfg)
        states.append(st)
    x = L.rmsnorm(x, model.final_norm)
    if return_hidden:
        return x
    if not cfg.causal:
        logits = torch.einsum("btd,dv->btv", x, model.head.to(x.dtype))
    else:
        logits = L.unembed(x, model.embed.to(x.dtype), cfg.logit_softcap)
    logits = constrain_act(logits, "btv")
    if return_states:
        return logits, states
    return logits


# ---------------------------------------------------------------------------
# decode (serve): per-layer recurrent/KV state
# ---------------------------------------------------------------------------

def _one_cache(cfg: ModelConfig, kind: str, b: int, max_len: int, dev):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=dev)
    if kind == "attn":
        s = min(max_len, cfg.local_window) if cfg.local_window else max_len
        kv = (b, s, cfg.n_kv, cfg.head_dim)
        return {"k": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
                "v": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
                "pos": torch.full((b, s), -1, dtype=torch.int32, device=dev)}
    if kind == "rglru":
        return (torch.zeros((b, 3, d), **f32), torch.zeros((b, d), **f32))
    if kind == "mlstm":
        hd = XL.EXPANSION * d // cfg.n_heads
        return (torch.zeros((b, cfg.n_heads, hd, hd), **f32),
                torch.zeros((b, cfg.n_heads, hd), **f32))
    if kind == "slstm":
        di = XL.EXPANSION * d
        return (torch.zeros((b, di), **f32), torch.zeros((b, di), **f32))
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device=None):
    """Decode state for every layer, in layer order, with the reference's
    layout per kind: attn -> {k, v (bf16), pos (int32, -1 = empty)}
    ring-buffered at min(max_len, local_window); rglru -> (conv_tail, h);
    mlstm -> (C, n); slstm -> (c, n), all f32.  ``index`` is a 0-dim int32
    tensor on the device."""
    dev = resolve_device(device)
    return {"layers": [_one_cache(cfg, cfg.block_kind(l), batch_size, max_len,
                                  dev) for l in range(cfg.n_layers)],
            "index": torch.zeros((), dtype=torch.int32, device=dev)}


def cache_to_numpy(cache: dict, cfg: ModelConfig) -> dict:
    """The cache in the reference's layout ({groups, remainder, index}),
    every leaf numpy; bf16 leaves come back as f32 (exact: numpy has no
    bfloat16)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    groups, rem = _stack(cfg, [_map(s, host) for s in cache["layers"]])
    return {"groups": groups, "remainder": rem,
            "index": np.int32(host(cache["index"]))}


def cache_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's cache pytree (numpy leaves) as the port's cache on
    ``device``, with the dtypes of ``init_cache``."""
    dev = resolve_device(device)

    def one(st):
        if isinstance(st, dict):            # attn: k, v bf16; pos int32
            return {n: _to_torch(a, dev).to(torch.int32 if n == "pos"
                                            else torch.bfloat16)
                    for n, a in st.items()}
        return tuple(_to_torch(a, dev).float() for a in st)

    return {"layers": [one(st) for st in _unstack(cfg, tree)],
            "index": _to_torch(np.asarray(tree["index"], np.int32), dev)}


def _attn_decode(cfg, p, x, positions, cache, index):
    """One-token attention with the ring-buffer KV cache, written in place
    at ``index % S``."""
    write = (index % cache["k"].shape[1]).long().reshape(1)
    q, k, v = L._qkv(p, x, positions, cfg.rope_theta)
    ck = cache["k"].index_copy_(1, write, k.to(cache["k"].dtype))
    cv = cache["v"].index_copy_(1, write, v.to(cache["v"].dtype))
    cpos = cache["pos"].index_copy_(1, write, positions)
    mask = L.attention_mask(positions, cpos, causal=cfg.causal,
                            local_window=cfg.local_window,
                            n_prefix=cfg.n_prefix) & (cpos >= 0)[:, None, :]
    out = L.gqa_attention(q, ck.to(q.dtype), cv.to(q.dtype), mask)
    out = L.einsum("btnh,nhd->btd", out, p["wo"])
    return out, {"k": ck, "v": cv, "pos": cpos}


@torch.no_grad()
def decode_step(model: LM, tokens, cache):
    """tokens: [B, 1] -> (logits [B, 1, vocab], cache advanced one step)."""
    cfg = model.cfg
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    index = cache["index"]
    dt = _dt(cfg.dtype)
    x = L.embed(tokens, model.embed).to(dt)
    scale = _gemma_scale(cfg)
    if scale is not None:
        x = (x.float() * scale).to(dt)
    positions = index.reshape(1, 1).expand(tokens.shape[0], 1)
    new = []
    for layer, st in zip(model.layers, cache["layers"]):
        x, st = layer(x, positions, cfg, st, index, decode=True)
        new.append(st)
    x = L.rmsnorm(x, model.final_norm)
    logits = L.unembed(x, model.embed.to(x.dtype), cfg.logit_softcap)
    return logits, {"layers": new, "index": index + 1}
