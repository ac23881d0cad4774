"""Training in the port (counterpart of train/): the six optimizers and the
Noam schedule, the train and eval steps of the AMT (every wiring), the
video regression (every backbone) and the MusicTransformer, metrics,
checkpoints in the port's own format, and the epoch loops ``train_amt``,
``train_regression`` and ``train_music_transformer``."""

from .checkpoint import load_weights, restore_checkpoint, save_checkpoint
from .loop import (CSV_HEADER, REG_CSV_HEADER, LoopConfig, train_amt,
                   train_music_transformer, train_regression)
from .optim import (Adam, Lion, RAdam, RAdanW, make_optimizer,
                    noam_schedule)
from .step import (TrainState, amt_loss, amt_separated_loss, build_model,
                   create_train_state, make_amt_eval_step,
                   make_amt_train_step, make_music_transformer_eval_step,
                   make_music_transformer_train_step,
                   make_regression_eval_step, make_regression_train_step,
                   regression_loss)

__all__ = ["Adam", "CSV_HEADER", "Lion", "LoopConfig", "RAdam", "RAdanW",
           "REG_CSV_HEADER", "TrainState", "amt_loss", "amt_separated_loss",
           "build_model", "create_train_state", "load_weights",
           "make_amt_eval_step", "make_amt_train_step",
           "make_music_transformer_eval_step",
           "make_music_transformer_train_step", "make_optimizer",
           "make_regression_eval_step", "make_regression_train_step",
           "noam_schedule", "regression_loss", "restore_checkpoint",
           "save_checkpoint", "train_amt", "train_music_transformer",
           "train_regression"]
