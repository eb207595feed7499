"""Model configuration for the architecture pool (the port's copy of
``repro.models.config``, field for field).

One dataclass covers all 10 architectures: dense decoders, MoE decoders,
the RG-LRU hybrid (recurrentgemma), xLSTM, the encoder-only audio backbone
(hubert) and the VLM backbone (paligemma).  Layer heterogeneity is expressed
as a repeating ``pattern`` of block kinds.  The reference stacks layers per
pattern position and scans them; the port keeps one module per layer
(``models.model.LM``).  ``scan_layers``, ``remat``, ``remat_policy``,
``param_sharding`` and ``opt_dtype`` are carried as data: they mean
something only to training and to the sharded model.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

BLOCK_KINDS = ("attn", "rglru", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads

    # layer pattern: tuple of block kinds, cycled over layers.  Examples:
    #   ("attn",)                      dense decoder
    #   ("rglru", "rglru", "attn")     recurrentgemma / griffin 1:2
    #   ("mlstm", "slstm")             xlstm
    pattern: Sequence[str] = ("attn",)

    # feed-forward
    act: str = "silu"                  # "silu" (swiglu) | "gelu" (geglu)
    # mixture of experts
    n_experts: int = 0
    top_k: int = 1
    moe_every: int = 1                 # MoE on layers where l % moe_every == moe_offset
    moe_offset: int = 0
    moe_capacity_factor: float = 1.25
    moe_dense_residual: bool = False   # arctic: dense FFN parallel to MoE
    moe_dense_ff: int = 0              # width of that residual (0 -> d_ff)

    # attention
    causal: bool = True                # False -> encoder (hubert)
    local_window: int = 0              # >0 -> sliding-window attention
    rope_theta: float = 10_000.0
    qkv_bias: bool = False             # qwen-style
    logit_softcap: float = 0.0         # gemma-style final softcap

    # modality frontend stubs ([audio]/[vlm]: precomputed embeddings in)
    frontend: str = "none"             # "none" | "audio_frames" | "vision_patches"
    frontend_dim: int = 0              # embedding dim delivered by the stub
    n_prefix: int = 0                  # prefix positions (vlm patches)

    # numerics / memory
    dtype: str = "bfloat16"            # activations
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "nothing"      # "nothing" | "dots" (save matmul outs:
                                       # ZeRO giants re-gather weights one
                                       # fewer time in the backward pass)
    param_sharding: str = "standard"   # "standard" | "fsdp" (ZeRO-3 weights)
    opt_dtype: str = "float32"         # adam moments (bf16 for the giants)
    scan_layers: bool = True

    # serving
    supports_decode: bool = True       # False for encoder-only
    subquadratic: bool = False         # True -> long_500k cell runs

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv, 1) == 0
        for k in self.pattern:
            assert k in BLOCK_KINDS, k

    @property
    def n_groups(self) -> int:
        """Number of scanned pattern groups (+ remainder layers unrolled)."""
        return self.n_layers // len(self.pattern)

    @property
    def n_remainder(self) -> int:
        return self.n_layers % len(self.pattern)

    def block_kind(self, layer: int) -> str:
        return self.pattern[layer % len(self.pattern)]

    def is_moe_layer(self, layer: int) -> bool:
        return (self.n_experts > 0
                and layer % self.moe_every == self.moe_offset)

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND MODEL_FLOPS cross-checks)."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        qkv = d * self.n_heads * hd + 2 * d * self.n_kv * hd + self.n_heads * hd * d
        n_ff_mats = 3 if self.act in ("silu", "gelu") else 2   # gated
        total = self.vocab * d                                  # embed (tied head)
        for l in range(self.n_layers):
            kind = self.block_kind(l)
            if kind == "attn":
                total += qkv
            elif kind == "rglru":
                total += 2 * d * d + 3 * d  # conv/in/out proj + gates (approx)
            elif kind in ("mlstm", "slstm"):
                total += 4 * d * 2 * d      # up/gates/down (expansion 2)
            if f > 0:
                if self.is_moe_layer(l):
                    total += self.n_experts * n_ff_mats * d * f
                    if self.moe_dense_residual:
                        total += n_ff_mats * d * (self.moe_dense_ff or f)
                    total += d * self.n_experts          # router
                else:
                    total += n_ff_mats * d * f
            total += 2 * d                               # norms
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_ff_mats = 3 if self.act in ("silu", "gelu") else 2
        dense_all = self.param_count()
        moe_layers = sum(self.is_moe_layer(l) for l in range(self.n_layers))
        inactive = moe_layers * (self.n_experts - self.top_k) * n_ff_mats * d * f
        return dense_all - inactive
