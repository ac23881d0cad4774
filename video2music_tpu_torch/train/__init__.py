"""AMT training in the port (counterpart of train/): optimizers and the
Noam schedule, the train and eval steps, metrics, checkpoints in the port's
own format, and the epoch loop ``train_amt``."""

from .checkpoint import restore_checkpoint, save_checkpoint
from .loop import CSV_HEADER, LoopConfig, train_amt
from .optim import Adam, make_optimizer, noam_schedule
from .step import (TrainState, amt_loss, create_train_state,
                   make_amt_eval_step, make_amt_train_step)

__all__ = ["Adam", "CSV_HEADER", "LoopConfig", "TrainState", "amt_loss",
           "create_train_state", "make_amt_eval_step", "make_amt_train_step",
           "make_optimizer", "noam_schedule", "restore_checkpoint",
           "save_checkpoint", "train_amt"]
