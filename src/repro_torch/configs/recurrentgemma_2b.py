"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern
[arXiv:2402.19427; hf].  26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; head_dim=256; sliding window 2048.  26 = 8 x (rglru, rglru,
attn) + 2 remainder rglru layers (Griffin ends on recurrent blocks)."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="recurrentgemma-2b", n_layers=26, d_model=2560, n_heads=10,
        n_kv=1, head_dim=256, d_ff=7680, vocab=256_000,
        pattern=("rglru", "rglru", "attn"), act="gelu",
        local_window=2048, subquadratic=True)


def smoke():
    return ModelConfig(
        name="recurrentgemma-smoke", n_layers=8, d_model=64, n_heads=2,
        n_kv=1, head_dim=32, d_ff=128, vocab=512,
        pattern=("rglru", "rglru", "attn"), act="gelu",
        local_window=16, subquadratic=True, remat=False)
