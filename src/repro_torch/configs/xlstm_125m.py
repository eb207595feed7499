"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
12L d_model=768 4H d_ff=0 (block-internal 2x expansion) vocab=50304.
Blocks alternate (mlstm, slstm); see DESIGN.md changed-assumptions for the
TPU adaptation of both recurrences."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="xlstm-125m", n_layers=12, d_model=768, n_heads=4, n_kv=4,
        d_ff=0, vocab=50_304, pattern=("mlstm", "slstm"),
        subquadratic=True)


def smoke():
    return ModelConfig(
        name="xlstm-smoke", n_layers=4, d_model=64, n_heads=2, n_kv=2,
        d_ff=0, vocab=512, pattern=("mlstm", "slstm"),
        subquadratic=True, remat=False)
