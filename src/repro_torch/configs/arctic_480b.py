"""arctic-480b [moe] — 128 experts top-2 + parallel dense residual FFN
[hf:Snowflake/snowflake-arctic-base; hf].  35L d_model=7168 56H (GQA kv=8)
expert d_ff=4864 vocab=32000.  ZeRO-3 weight sharding + bf16 optimizer
moments (DESIGN.md §5 memory budget).  56 heads do not divide the 16-way
model axis -> attention falls back to data-parallel; the MoE (the dominant
FLOPs) shards 128 experts over 'model'."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv=8,
        d_ff=4864, vocab=32_000, n_experts=128, top_k=2,
        moe_dense_residual=True, moe_dense_ff=4864,
        param_sharding="fsdp", opt_dtype="bfloat16",
        remat_policy="dots")


def smoke():
    return ModelConfig(
        name="arctic-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_ff=96, vocab=512, n_experts=4, top_k=2,
        moe_dense_residual=True, moe_dense_ff=96, remat=False)
