"""Training: tuple losses, the parameter-group optimizer, the train step,
tuple mining and the ``Trainer`` loop; the LoFTR trainer (``train.loftr``)."""

from .optim import FROZEN_PREFIXES, make_optimizer, param_labels
from .step import (
    TrainState,
    apply_gradients,
    init_train_state,
    make_grad_fn,
    make_loss_fn,
    make_train_step,
)
from .loftr import (
    LoFTRTrainState,
    init_loftr_train_state,
    make_loftr_optimizer,
    make_loftr_train_step,
    random_homography,
    warp_image,
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
    "TrainState", "apply_gradients", "init_train_state", "make_grad_fn", "make_loss_fn",
    "make_train_step",
    "EpochMetrics", "TrainConfig", "Trainer", "make_retrieval_eval",
    "TupleSpec", "TuplesDataset", "batch_tuples", "tuples_from_db_pickle",
    "tuples_from_folders", "whiten_db_from_pickle",
    "LoFTRTrainState", "init_loftr_train_state", "make_loftr_optimizer",
    "make_loftr_train_step", "random_homography", "warp_image",
]
