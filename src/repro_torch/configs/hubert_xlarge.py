"""hubert-xlarge [audio] — encoder-only masked-prediction backbone
[arXiv:2106.07447; unverified].  48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (k-means target codebook).  The CNN waveform frontend is a STUB:
input_specs() delivers precomputed 512-dim frame embeddings (the brief's
contract for [audio] entries)."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="hubert-xlarge", n_layers=48, d_model=1280, n_heads=16,
        n_kv=16, d_ff=5120, vocab=504, causal=False, act="gelu",
        frontend="audio_frames", frontend_dim=512,
        supports_decode=False)


def smoke():
    return ModelConfig(
        name="hubert-smoke", n_layers=4, d_model=64, n_heads=4, n_kv=4,
        d_ff=128, vocab=37, causal=False, act="gelu",
        frontend="audio_frames", frontend_dim=24,
        supports_decode=False, remat=False)
