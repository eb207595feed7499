"""Checkpoints of the port (counterpart of ``repro.checkpoint``): npz
shards plus a JSON manifest per step, per-level tree-build checkpoints
that cross-load with the reference's, and round checkpoints of a boosted
fit that resume it bit for bit."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step, restore_pytree, save_pytree,
)
from repro_torch.checkpoint.round_ckpt import (  # noqa: F401
    CheckpointCorruptError, CheckpointMismatchError, RoundCheckpoint,
    RoundCheckpointer, RoundState, fit_digest, resolve_resume,
    restore_round_state,
)
from repro_torch.checkpoint.tree_ckpt import (  # noqa: F401
    TreeCheckpointer, restore_build_state,
)
