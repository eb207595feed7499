"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295; hf].
28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="gemma-7b", n_layers=28, d_model=3072, n_heads=16, n_kv=16,
        head_dim=256, d_ff=24_576, vocab=256_000, act="gelu")


def smoke():
    return ModelConfig(
        name="gemma-smoke", n_layers=3, d_model=64, n_heads=4, n_kv=4,
        head_dim=32, d_ff=192, vocab=512, act="gelu", remat=False)
