"""The paper's own workload: Ultrafast Decision Tree training config."""
from repro_torch.core.tree import TreeConfig


def config():
    # paper-scale: full tree, no limits (Table 6 protocol)
    return TreeConfig(max_depth=64, min_samples_split=2,
                      heuristic="info_gain")


def smoke():
    return TreeConfig(max_depth=8, min_samples_split=2, chunk_slots=32)
