"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM; hf].
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="smollm-360m", n_layers=32, d_model=960, n_heads=15, n_kv=5,
        d_ff=2560, vocab=49_152)


def smoke():
    return ModelConfig(
        name="smollm-smoke", n_layers=3, d_model=60, n_heads=3, n_kv=1,
        d_ff=128, vocab=512, remat=False)
