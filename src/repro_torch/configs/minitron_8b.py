"""minitron-8b [dense] — width/depth-pruned nemotron [arXiv:2407.14679; hf].
32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="minitron-8b", n_layers=32, d_model=4096, n_heads=32, n_kv=8,
        d_ff=16_384, vocab=256_000)


def smoke():
    return ModelConfig(
        name="minitron-smoke", n_layers=3, d_model=64, n_heads=8, n_kv=2,
        d_ff=160, vocab=512, remat=False)
