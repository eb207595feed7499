"""Superfast Selection + Ultrafast Decision Tree in PyTorch (the port of
``repro.core``).

Public API:
    fit_bins / transform        host-side hybrid-feature binning (numpy)
    build_tree / TreeConfig     level-synchronous UDT training
    predict_bins / paths        Algorithm 7 predict (runtime hyper-params)
    best_splits                 vectorised Superfast Selection
"""
from repro_torch.core.binning import (  # noqa: F401
    BinnedTable, FeatureMeta, fit_bins, transform, fit_label_classes,
)
from repro_torch.core.heuristics import HEURISTICS  # noqa: F401
from repro_torch.core.histogram import (  # noqa: F401
    node_histogram, node_histogram_smaller_child, node_histogram_sibling_fused,
    class_stats, moment_stats,
)
from repro_torch.core.split import (  # noqa: F401
    best_splits, best_splits_kernel, evaluate_predicate, SplitDecision,
    OP_LE, OP_GT, OP_EQ,
)
from repro_torch.core.tree import (  # noqa: F401
    Tree, TreeConfig, build_tree, BuildState, tree_from_numpy,
)
from repro_torch.core.predict import (  # noqa: F401
    predict_bins, paths, stack_trees,
)
