from repro_torch.data.synthetic import (  # noqa: F401
    make_classification, make_regression, make_hybrid_table, train_val_test_split,
    DATASET_ZOO, make_dataset,
)
from repro_torch.data.kdd99 import (  # noqa: F401
    SUPERCLASSES, load_kdd99, synth_kdd99,
)
