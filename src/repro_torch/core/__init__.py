"""Superfast Selection + Ultrafast Decision Tree in PyTorch (the port of
``repro.core``).

Public API:
    fit_bins / transform        host-side hybrid-feature binning (numpy)
    build_tree / TreeConfig     level-synchronous UDT training
    predict_bins / paths        Algorithm 7 predict (runtime hyper-params)
    tune / toot_grid            Training-Only-Once Tuning
    sweep / SweepSpace          TOOT design-space engine + Pareto fronts
    best_splits                 vectorised Superfast Selection
    build_trees_batched         C class-trees through one batched build
    walk_class_trees            C trees walked at once
    RandomForest                bagged UDTs with feature masks
    GradientBoostedTrees        Newton-step boosting (squared / logistic /
                                softmax), with GOSS and round checkpoints
    build_tree_distributed      the sharded build over a torch.distributed
    DistributedBuilder / DistConfig   DeviceMesh (one process per rank)
"""
from repro_torch.core.binning import (  # noqa: F401
    BinnedTable, FeatureMeta, fit_bins, transform, fit_label_classes,
)
from repro_torch.core.heuristics import HEURISTICS  # noqa: F401
from repro_torch.core.histogram import (  # noqa: F401
    node_histogram, node_histogram_smaller_child, node_histogram_sibling_fused,
    node_histogram_stacked, node_histogram_sibling_fused_stacked,
    class_stats, moment_stats,
)
from repro_torch.core.split import (  # noqa: F401
    best_splits, best_splits_kernel, evaluate_predicate, SplitDecision,
    OP_LE, OP_GT, OP_EQ,
)
from repro_torch.core.tree import (  # noqa: F401
    Tree, TreeConfig, build_tree, build_trees_batched, BuildState,
    tree_from_numpy,
)
from repro_torch.core.predict import (  # noqa: F401
    predict_bins, paths, stack_trees, walk_class_trees,
)
from repro_torch.core.tuning import (  # noqa: F401
    tune, toot_grid, prune_stats, TuneResult,
    sweep, path_tables, pareto_front, default_smin_values,
    SweepSpace, SweepResult, ParetoPoint,
)
from repro_torch.core.forest import (  # noqa: F401
    GossConfig, GradientBoostedTrees, RandomForest, ensemble_from_numpy,
)
from repro_torch.core.losses import (  # noqa: F401
    LogisticLoss, SoftmaxLoss, SquaredLoss, LOSSES, get_loss,
)
from repro_torch.core.distributed import (  # noqa: F401
    DistConfig, DistributedBuilder, build_tree_distributed,
)
