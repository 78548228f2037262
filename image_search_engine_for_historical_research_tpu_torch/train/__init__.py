"""Training: tuple losses, the parameter-group optimizer, the train step,
tuple mining and the ``Trainer`` loop. The LoFTR trainer is not ported yet
(ROADMAP section 1, item 4)."""

from .optim import FROZEN_PREFIXES, make_optimizer, param_labels
from .step import (
    TrainState,
    apply_gradients,
    init_train_state,
    make_loss_fn,
    make_train_step,
)
from .trainer import EpochMetrics, TrainConfig, Trainer, make_retrieval_eval
from .tuples import (
    TupleSpec,
    TuplesDataset,
    batch_tuples,
    tuples_from_db_pickle,
    tuples_from_folders,
    whiten_db_from_pickle,
)

__all__ = [
    "FROZEN_PREFIXES", "make_optimizer", "param_labels",
    "TrainState", "apply_gradients", "init_train_state", "make_loss_fn", "make_train_step",
    "EpochMetrics", "TrainConfig", "Trainer", "make_retrieval_eval",
    "TupleSpec", "TuplesDataset", "batch_tuples", "tuples_from_db_pickle",
    "tuples_from_folders", "whiten_db_from_pickle",
]
