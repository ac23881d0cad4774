"""The epoch loops on one device (counterpart of train/loop.py):

  * ``train_amt`` (any AMT wiring): per epoch a train pass over shuffled
    batches (threaded prefetch, each batch copied to the device ahead of
    its step), an eval pass on the train split (``eval_train_subset``)
    and on the val split, one ``results.csv`` row with the JAX package's
    header, ``best_loss_weights`` on a new best val loss (and
    ``best_epochs.txt``), and ``epoch_NNNN`` snapshots every
    ``weight_modulus`` epochs; ``continue_from`` and ``auto_resume``
    restore a checkpoint of the port's format (train/checkpoint.py);
  * ``train_regression``: a train pass, the val pass's RMSE per head and
    instrument BCE, ``weights/best_rmse_weights`` on a new best total
    RMSE, one ``REG_CSV_HEADER`` row per epoch;
  * ``train_music_transformer``: a train pass, the val pass,
    ``weights/best_loss_weights`` on a new best val loss, one
    ``CSV_HEADER`` row with the train and emotion columns empty.

Not ported, and raising: meshes and the parallel strategies, the profiler
(``profile_steps``) and TensorBoard (``tensorboard_dir``) (ROADMAP.md,
Queue 1 item 13).
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from ..core.config import (AMTConfig, MusicTransformerConfig,
                           RegressionConfig, TrainConfig)
from ..data.dataset import batches as make_batches
from ..data.loader import PrefetchLoader, device_prefetch
from . import checkpoint as ckpt
from .optim import noam_schedule
from .step import (TrainState, create_train_state, make_amt_eval_step,
                   make_amt_train_step, make_music_transformer_eval_step,
                   make_music_transformer_train_step,
                   make_regression_eval_step, make_regression_train_step,
                   resolve_device)

def not_ported(what: str, queue_item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to video2music_tpu_torch yet "
        f"(ROADMAP.md, {queue_item})")


CSV_HEADER = [
    "Epoch", "Learn rate",
    "Avg Train loss (total)", "Avg Train loss (chord)",
    "Avg Train loss (emotion)",
    "Avg Train h1", "Avg Train h3", "Avg Train h5",
    "Avg Eval loss (total)", "Avg Eval loss (chord)",
    "Avg Eval loss (emotion)",
    "Avg Eval h1", "Avg Eval h3", "Avg Eval h5",
]

REG_CSV_HEADER = [
    "Epoch", "Learn rate", "Avg Train loss (total)",
    "Avg Eval loss (total)", "Eval RMSE (note density)",
    "Eval RMSE (loudness)", "Eval BCE (instrument)",
]


@dataclass
class LoopConfig:
    epochs: int = 50
    batch_size: int = 32
    output_dir: str = "./saved_models"
    weight_modulus: int = 1          # epoch snapshot period
    eval_train_subset: bool = True
    seed: int = 0                    # the loader's shuffle
    continue_from: Optional[str] = None
    # Noam schedule offset (a restore's optimizer count adds to it)
    init_steps: int = 0
    # resume from the newest epoch_NNNN snapshot in output_dir/weights
    auto_resume: bool = False
    profile_steps: int = 0
    tensorboard_dir: Optional[str] = None
    log_fn: Callable[[str], None] = print


def _mean_metrics(rows) -> Dict[str, float]:
    """Average per-batch metric dicts; correspondence ignores -1 batches
    (no frame passed the emotion filter)."""
    if not rows:
        return {}
    out = {}
    for k in rows[0]:
        vals = np.asarray([float(r[k]) for r in rows])
        if k == "correspondence":
            vals = vals[vals >= 0.0]
            out[k] = float(vals.mean()) if vals.size else -1.0
        else:
            out[k] = float(vals.mean())
    return out


def _latest_epoch_snapshot(weights_dir: str):
    """(path, epoch) of the newest epoch_NNNN checkpoint, or (None, 0)."""
    best, best_epoch = None, 0
    if os.path.isdir(weights_dir):
        for name in os.listdir(weights_dir):
            if name.startswith("epoch_"):
                try:
                    e = int(name.split("_", 1)[1])
                except ValueError:
                    continue
                if e > best_epoch:
                    best, best_epoch = os.path.join(weights_dir, name), e
    return best, best_epoch


def _start(cfg, tcfg: TrainConfig, loop: LoopConfig, device):
    """The output tree and a fresh train state: (device, results.csv path,
    weights dir, state)."""
    if loop.profile_steps or loop.tensorboard_dir:
        raise not_ported("the step profiler and TensorBoard",
                         "Queue 1 item 13")
    dev = resolve_device(device)
    os.makedirs(loop.output_dir, exist_ok=True)
    weights_dir = os.path.join(loop.output_dir, "weights")
    os.makedirs(weights_dir, exist_ok=True)
    state = create_train_state(cfg, tcfg, device=dev,
                               init_steps=loop.init_steps)
    return dev, os.path.join(loop.output_dir, "results.csv"), weights_dir, \
        state


def _csv_header(path: str, header) -> None:
    """Start the CSV at ``path`` with ``header`` unless it exists (a
    resumed run appends)."""
    if not os.path.isfile(path):
        _csv_row(path, header)


def _csv_row(path: str, row) -> None:
    with open(path, "a", newline="") as f:
        csv.writer(f).writerow(row)


def _epoch_pass(step_fn, state, batches_iter, device):
    rows = []
    for batch in device_prefetch(batches_iter, device):
        state, m = step_fn(state, batch)
        rows.append(m)
    return state, rows


def _eval_pass(eval_fn, state, dataset, batch_size):
    rows = [eval_fn(state.model, batch) for batch in device_prefetch(
        make_batches(dataset, batch_size, shuffle=False), state.device)]
    return _mean_metrics(rows)


def train_amt(model_cfg: AMTConfig, tcfg: TrainConfig, loop: LoopConfig,
              train_ds, val_ds, *, drop_loss: bool = False, device=None,
              mesh=None, parallel: str = "dp") -> TrainState:
    """A full AMT training run on one device (CUDA unless ``device`` says
    otherwise; raises without CUDA). Returns the final state; writes
    ``results.csv``, ``weights/best_loss_weights``,
    ``weights/epoch_NNNN`` and ``best_epochs.txt`` under
    ``loop.output_dir``."""
    if mesh is not None or parallel != "dp":
        raise not_ported("meshes and parallel training strategies",
                         "Queue 1 item 13")
    dev, results_file, weights_dir, state = _start(model_cfg, tcfg, loop,
                                                   device)
    start_epoch = 0
    if not loop.continue_from and loop.auto_resume:
        snap, start_epoch = _latest_epoch_snapshot(weights_dir)
        if snap:
            loop = dataclasses.replace(loop, continue_from=snap)
            loop.log_fn(f"auto-resume: epoch {start_epoch} from {snap}")
    if loop.continue_from:
        state = ckpt.restore_checkpoint(loop.continue_from, state)

    train_step = make_amt_train_step(tcfg, drop_loss=drop_loss)
    eval_step = make_amt_eval_step(tcfg)
    sched = noam_schedule(model_cfg.d_model, tcfg.warmup_steps)

    _csv_header(results_file, CSV_HEADER)
    best_eval_loss, best_epoch = float("inf"), -1
    loader = PrefetchLoader(train_ds, loop.batch_size, shuffle=True,
                            seed=loop.seed)
    for epoch in range(start_epoch, loop.epochs):
        t0 = time.time()
        state, _ = _epoch_pass(train_step, state, loader, dev)
        train_m = (_eval_pass(eval_step, state, train_ds, loop.batch_size)
                   if loop.eval_train_subset else {})
        eval_m = _eval_pass(eval_step, state, val_ds, loop.batch_size)
        lr = float(sched(state.step)) if tcfg.lr is None else tcfg.lr
        loop.log_fn(
            f"epoch {epoch + 1}/{loop.epochs} "
            f"val_loss={eval_m['loss']:.4f} h1={eval_m['hits@1']:.4f} "
            f"h3={eval_m['hits@3']:.4f} h5={eval_m['hits@5']:.4f} "
            f"({time.time() - t0:.1f}s)")

        if eval_m["loss"] < best_eval_loss:
            best_eval_loss, best_epoch = eval_m["loss"], epoch + 1
            ckpt.save_checkpoint(
                os.path.join(weights_dir, "best_loss_weights"), state)
            with open(os.path.join(loop.output_dir, "best_epochs.txt"),
                      "w") as f:
                f.write(f"Best val loss epoch: {best_epoch}\n"
                        f"Best val loss: {best_eval_loss}\n")
        if (epoch + 1) % loop.weight_modulus == 0:
            ckpt.save_checkpoint(
                os.path.join(weights_dir, f"epoch_{epoch + 1:04d}"), state)

        _csv_row(results_file, [
            epoch + 1, lr,
            train_m.get("loss", ""), train_m.get("loss_chord", ""),
            train_m.get("loss_emotion", ""),
            train_m.get("hits@1", ""), train_m.get("hits@3", ""),
            train_m.get("hits@5", ""),
            eval_m["loss"], eval_m["loss_chord"], eval_m["loss_emotion"],
            eval_m["hits@1"], eval_m["hits@3"], eval_m["hits@5"],
        ])
    return state


def train_regression(model_cfg: RegressionConfig, tcfg: TrainConfig,
                     loop: LoopConfig, train_ds, val_ds, *,
                     device=None) -> TrainState:
    """A regression training run on one device (CUDA unless ``device``
    says otherwise). Per epoch: the train pass, then on the val split the
    RMSE of note density and of loudness (from the summed squared errors)
    and the mean instrument BCE; ``weights/best_rmse_weights`` on a new
    best total RMSE; a ``REG_CSV_HEADER`` row in ``results.csv``."""
    dev, results_file, weights_dir, state = _start(model_cfg, tcfg, loop,
                                                   device)
    if loop.continue_from:
        state = ckpt.restore_checkpoint(loop.continue_from, state)
    train_step = make_regression_train_step(tcfg)
    eval_step = make_regression_eval_step()
    _csv_header(results_file, REG_CSV_HEADER)
    best_rmse = float("inf")
    loader = PrefetchLoader(train_ds, loop.batch_size, shuffle=True,
                            seed=loop.seed)
    for epoch in range(loop.epochs):
        state, train_rows = _epoch_pass(train_step, state, loader, dev)
        train_loss = float(np.mean([float(r["loss"]) for r in train_rows]))
        rows = [eval_step(state.model, batch) for batch in device_prefetch(
            make_batches(val_ds, loop.batch_size, shuffle=False), dev)]
        total = {k: sum(float(r[k]) for r in rows)
                 for k in ("se_note_density", "se_loudness", "count")}
        n = max(total["count"], 1.0)
        rmse_nd = float(np.sqrt(total["se_note_density"] / n))
        rmse_ln = float(np.sqrt(total["se_loudness"] / n))
        bce = float(np.mean([float(r["bce_instrument"]) for r in rows]))
        eval_loss = float(np.mean([float(r["loss"]) for r in rows]))
        loop.log_fn(f"epoch {epoch + 1}/{loop.epochs} "
                    f"rmse_nd={rmse_nd:.4f} rmse_loud={rmse_ln:.4f} "
                    f"bce={bce:.4f}")
        if rmse_nd + rmse_ln < best_rmse:
            best_rmse = rmse_nd + rmse_ln
            ckpt.save_checkpoint(
                os.path.join(weights_dir, "best_rmse_weights"), state)
        _csv_row(results_file, [epoch + 1, tcfg.lr or "", train_loss,
                                eval_loss, rmse_nd, rmse_ln, bce])
    return state


def train_music_transformer(model_cfg: MusicTransformerConfig,
                            tcfg: TrainConfig, loop: LoopConfig, train_ds,
                            val_ds, *, device=None) -> TrainState:
    """A MusicTransformer (no-video) training run on one device: the chord
    CE; ``weights/best_loss_weights`` on a new best val loss; a
    ``CSV_HEADER`` row per epoch with the train and emotion columns
    empty."""
    dev, results_file, weights_dir, state = _start(model_cfg, tcfg, loop,
                                                   device)
    if loop.continue_from:
        state = ckpt.restore_checkpoint(loop.continue_from, state)
    train_step = make_music_transformer_train_step(tcfg)
    eval_step = make_music_transformer_eval_step(tcfg)
    _csv_header(results_file, CSV_HEADER)
    best_eval_loss = float("inf")
    loader = PrefetchLoader(train_ds, loop.batch_size, shuffle=True,
                            seed=loop.seed)
    for epoch in range(loop.epochs):
        t0 = time.time()
        state, _ = _epoch_pass(train_step, state, loader, dev)
        eval_m = _eval_pass(eval_step, state, val_ds, loop.batch_size)
        loop.log_fn(f"epoch {epoch + 1}/{loop.epochs} "
                    f"val_loss={eval_m['loss']:.4f} "
                    f"h1={eval_m['hits@1']:.4f} ({time.time() - t0:.1f}s)")
        if eval_m["loss"] < best_eval_loss:
            best_eval_loss = eval_m["loss"]
            ckpt.save_checkpoint(
                os.path.join(weights_dir, "best_loss_weights"), state)
        _csv_row(results_file, [
            epoch + 1, "", "", "", "", "", "", "",
            eval_m["loss"], eval_m["loss"], "",
            eval_m["hits@1"], eval_m["hits@3"], eval_m["hits@5"]])
    return state
