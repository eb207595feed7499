from repro_torch.data.synthetic import (  # noqa: F401
    make_classification, make_regression, make_hybrid_table, train_val_test_split,
    DATASET_ZOO, make_dataset,
)
from repro_torch.data.kdd99 import SUPERCLASSES, synth_kdd99  # noqa: F401
