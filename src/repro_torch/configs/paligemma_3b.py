"""paligemma-3b [vlm] — SigLIP patches + gemma-2b backbone, prefix-LM
attention (bidirectional over the 256 patch positions)
[arXiv:2407.07726; hf].  18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216.  The SigLIP tower is a STUB: input_specs() provides
precomputed 1152-dim patch embeddings."""
from repro_torch.models.config import ModelConfig

N_PATCHES = 256


def config():
    return ModelConfig(
        name="paligemma-3b", n_layers=18, d_model=2048, n_heads=8, n_kv=1,
        head_dim=256, d_ff=16_384, vocab=257_216, act="gelu",
        frontend="vision_patches", frontend_dim=1152, n_prefix=N_PATCHES)


def smoke():
    return ModelConfig(
        name="paligemma-smoke", n_layers=3, d_model=64, n_heads=4, n_kv=1,
        d_ff=128, vocab=512, act="gelu", frontend="vision_patches",
        frontend_dim=48, n_prefix=8, remat=False)
