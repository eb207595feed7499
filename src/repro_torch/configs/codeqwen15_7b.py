"""codeqwen1.5-7b [dense] — qwen1.5 geometry with qkv bias
[hf:Qwen/CodeQwen1.5-7B; hf].  32L d_model=4096 32H (kv=32, MHA)
d_ff=13440 vocab=92416."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv=32, d_ff=13_440, vocab=92_416, qkv_bias=True)


def smoke():
    return ModelConfig(
        name="codeqwen-smoke", n_layers=3, d_model=64, n_heads=4, n_kv=4,
        d_ff=160, vocab=512, qkv_bias=True, remat=False)
