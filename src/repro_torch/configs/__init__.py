"""Architecture registry of the port (counterpart of ``repro.configs``,
table for table): one module per assigned architecture, and ``udt_paper``
(the tree reproduction's own training config).

Each module exports ``config()`` (the exact published geometry) and
``smoke()`` (a reduced same-family config for CPU smoke tests).
``get(name)`` / ``get_smoke(name)`` dispatch by id; ``SHAPES`` defines the
assigned input-shape set and ``cells()`` enumerates the 40 (arch x shape)
dry-run cells with skip annotations.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "recurrentgemma_2b",
    "hubert_xlarge",
    "xlstm_125m",
    "arctic_480b",
    "llama4_maverick_400b_a17b",
    "paligemma_3b",
    "gemma_7b",
    "minitron_8b",
    "smollm_360m",
    "codeqwen15_7b",
]

# canonical external ids (--arch flag accepts either form)
ALIASES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "hubert-xlarge": "hubert_xlarge",
    "xlstm-125m": "xlstm_125m",
    "arctic-480b": "arctic_480b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "paligemma-3b": "paligemma_3b",
    "gemma-7b": "gemma_7b",
    "minitron-8b": "minitron_8b",
    "smollm-360m": "smollm_360m",
    "codeqwen1.5-7b": "codeqwen15_7b",
}

# shape id -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def _mod(name: str):
    key = ALIASES.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str):
    return _mod(name).config()


def get_smoke(name: str):
    return _mod(name).smoke()


def shape_skip_reason(cfg, shape_id: str) -> str | None:
    """Returns a skip reason or None if the (arch, shape) cell runs."""
    _, _, kind = SHAPES[shape_id]
    if kind == "decode" and not cfg.supports_decode:
        return "encoder-only: no decode step"
    if shape_id == "long_500k" and not cfg.subquadratic:
        return "full quadratic attention: 500k context infeasible (DESIGN.md)"
    return None


def cells():
    """All 40 (arch x shape) cells with their skip annotation."""
    out = []
    for a in ARCH_IDS:
        cfg = get(a)
        for s in SHAPES:
            out.append((a, s, shape_skip_reason(cfg, s)))
    return out
