"""LM training of the port (counterpart of ``repro.train``): the
hand-written AdamW and the train step."""
from repro_torch.train.optimizer import adamw_init, adamw_update  # noqa: F401
from repro_torch.train.train_step import (  # noqa: F401
    TrainState, make_train_step, loss_fn, init_train_state,
)
