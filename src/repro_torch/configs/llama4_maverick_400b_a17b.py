"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, MoE on alternating
layers (interleaved MoE matches the 400B-total / 17B-active budget; the
brief's d_ff=8192 on every layer x 48 would be ~770B)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120,
        n_heads=40, n_kv=8, d_ff=8192, vocab=202_048,
        pattern=("attn", "attn"), n_experts=128, top_k=1,
        moe_every=2, moe_offset=1,
        param_sharding="fsdp", opt_dtype="bfloat16",
        remat_policy="dots")


def smoke():
    return ModelConfig(
        name="llama4-smoke", n_layers=4, d_model=64, n_heads=4, n_kv=2,
        d_ff=128, vocab=512, pattern=("attn", "attn"), n_experts=4,
        top_k=1, moe_every=2, moe_offset=1, remat=False)
