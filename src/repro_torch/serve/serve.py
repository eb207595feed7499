"""Batched LM serving: prefill + single-token decode steps (counterpart of
``repro.serve.serve``).

``serve_step`` is one new token against a KV/recurrent cache; ``generate``
is the driver (greedy, or temperature sampling).  Everything stays on the
model's device: greedy decoding is ``argmax`` there, temperature sampling
is Gumbel-max with an explicit generator there -- the method behind
``jax.random.categorical``, so the port draws from the same distribution,
not the same bits -- and no step reads a value back to the host.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.models import model as M

__all__ = ["make_serve_step", "prefill", "decode_loop", "generate"]


def make_serve_step(model):
    """serve_step(tokens [B,1], cache) -> (next_token, logits, cache).  The
    reference closes over its config; the port's model carries it."""

    def serve_step(tokens, cache):
        logits, cache = M.decode_step(model, tokens, cache)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], logits, cache

    return serve_step


def prefill(model, tokens, max_len: int):
    """Run the prompt through ``decode_step`` token by token, building the
    decode cache (simple and cache-layout exact, as in the reference)."""
    cache = M.init_cache(model.cfg, tokens.shape[0], max_len, model.device)
    logits = None
    for i in range(tokens.shape[1]):
        logits, cache = M.decode_step(model, tokens[:, i:i + 1], cache)
    return logits, cache


def _sample(logits, temperature, generator):
    """Gumbel-max: argmax(logits / T + G), G = -log(-log(U)), U uniform."""
    scaled = logits[:, -1].float() / temperature
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1).to(
        torch.int32)[:, None]


def decode_loop(model, logits, cache, n_tokens: int, temperature: float = 0.0,
                generator: torch.Generator | None = None):
    """The loop of ``generate``: ``n_tokens`` tokens from the prefill's
    last logits; returns (tokens [B, n_tokens] int32 on the device,
    cache)."""
    step = make_serve_step(model)
    out = []
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    for _ in range(n_tokens):
        out.append(tok)
        tok, logits, cache = step(tok, cache)
        if temperature > 0:
            tok = _sample(logits, temperature, generator)
    return torch.cat(out, dim=1), cache


def generate(model, prompt, n_tokens: int, max_len: int,
             temperature: float = 0.0, generator: torch.Generator | None = None,
             *, device=None):
    """Greedy / temperature generation on ``device`` (``None`` means CUDA),
    where the model and ``prompt`` [B, T] must already be.  Temperature
    sampling draws from ``generator`` (required when temperature > 0).
    Returns the tokens [B, n_tokens] int32 on the device."""
    dev = resolve_device(device)
    if model.device.type != dev.type or prompt.device.type != dev.type:
        raise ValueError(f"generate on {dev}: the model is on {model.device} "
                         f"and the prompt on {prompt.device}")
    if temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    logits, cache = prefill(model, prompt, max_len)
    return decode_loop(model, logits, cache, n_tokens, temperature,
                       generator)[0]
