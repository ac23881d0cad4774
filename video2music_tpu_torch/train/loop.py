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

``tensorboard_dir`` streams ``train_amt``'s four per-epoch tags with
1-based steps through the first-party event writer (obs/tensorboard.py),
as the JAX loop does (only ``train_amt`` writes them there too);
``profile_steps=N`` traces steps 1..N of the first epoch once with
``torch.profiler`` (CPU and, on a card, CUDA activities) into a Chrome
trace file in ``profile_dir`` (:class:`StepProfiler`).

``train_amt(mesh=..., parallel=..., n_microbatches=...)`` trains on a
("data", "model") mesh of ranks (parallel/): "dp" (the batch over "data";
expert stacks over "model" where it divides them), "tp" (dp plus
Megatron column / row splits), "sp" (tp plus the sequence-sharded
residual stream; the config must set ``sequence_parallel``) or "pp"
(GPipe stages over "model", train/pp.py). Every rank calls it: each reads
the same shuffled global batches and takes its rows, ragged trailing
batches are dropped with one notice (sharded steps need full batches),
the eval metrics are the global batches', and rank 0 alone writes
``results.csv``, TensorBoard, the profiler trace and the checkpoints
(gathered whole, so they load as the single-device ones do).
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

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
    # trace train steps 1..N of the first epoch into profile_dir
    profile_steps: int = 0
    profile_dir: str = "./profile"
    # TensorBoard scalars (train_amt's four tags per epoch); None: none
    tensorboard_dir: Optional[str] = None
    log_fn: Callable[[str], None] = print


def _make_tb(loop: LoopConfig):
    if not loop.tensorboard_dir:
        return None
    from ..obs.tensorboard import SummaryWriter

    return SummaryWriter(loop.tensorboard_dir)


class StepProfiler:
    """Traces steps [1, 1+n) of the first epoch pass it sees, once
    (``torch.profiler``: CPU activities, and CUDA ones on a card), into
    ``out_dir/trace_steps_1-<n>.json`` (a Chrome trace)."""

    def __init__(self, n_steps: int, out_dir: str, device, log_fn=print):
        self.n = n_steps
        self.dir = out_dir
        self.device = torch.device(device)
        self.log_fn = log_fn
        self._prof = None
        self._done = n_steps <= 0

    def maybe_start(self, i: int) -> None:
        if self._done or self._prof is not None or i != 1:
            return
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(self.dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def maybe_stop(self, i: int) -> None:
        if self._prof is None or i < self.n:
            return
        # the queued steps must finish before the trace is read, or the
        # device timeline is cut short
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self._prof.export_chrome_trace(
            os.path.join(self.dir, f"trace_steps_1-{i}.json"))
        self._prof, self._done = None, True
        self.log_fn(f"profiled steps 1..{i} -> {self.dir} "
                    "(TensorBoard profile plugin / xprof)")


def _make_profiler(loop: LoopConfig, device):
    return (StepProfiler(loop.profile_steps, loop.profile_dir, device,
                         loop.log_fn)
            if loop.profile_steps > 0 else None)


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


def _epoch_pass(step_fn, state, batches_iter, device,
                profiler: Optional[StepProfiler] = None):
    rows = []
    for i, batch in enumerate(device_prefetch(batches_iter, device)):
        if profiler is not None:
            profiler.maybe_start(i)
        state, m = step_fn(state, batch)
        rows.append(m)
        if profiler is not None:
            profiler.maybe_stop(i)
    return state, rows


def _eval_pass(eval_fn, state, dataset, batch_size, mesh=None,
               log_fn=print):
    batches = make_batches(dataset, batch_size, shuffle=False)
    if mesh is not None:
        batches = _local_batches(batches, batch_size, mesh, log_fn)
    rows = [eval_fn(state.model, batch)
            for batch in device_prefetch(batches, state.device)]
    return _mean_metrics(rows)


def _full_batches(batches_iter, batch_size: int, log_fn):
    """Drop ragged trailing batches (a sharded step needs every batch
    divisible by the data axis and the microbatch count). The reference's
    DataLoader keeps partial batches (drop_last defaults False); single-
    device runs do too, only mesh runs drop, with a one-time notice."""
    warned = False
    for batch in batches_iter:
        n = next(iter(batch.values())).shape[0]
        if n != batch_size:
            if not warned:
                log_fn(f"mesh run: dropping ragged batch of {n} "
                       f"(< batch_size {batch_size}) — sharded steps need "
                       "full batches")
                warned = True
            continue
        yield batch


def _local_batches(batches_iter, batch_size: int, mesh, log_fn):
    """This rank's rows of each full global batch."""
    from ..parallel import shard_batch
    for batch in _full_batches(batches_iter, batch_size, log_fn):
        yield shard_batch(mesh, batch)


def check_mesh_run(model_cfg: AMTConfig, batch_size: int, mesh,
                   parallel: str, n_microbatches: int) -> None:
    """The JAX loop's checks of a mesh run (its messages)."""
    if parallel not in ("dp", "tp", "sp", "pp"):
        raise ValueError(f"unknown parallel strategy {parallel!r}")
    if parallel == "sp" and not model_cfg.sequence_parallel:
        raise ValueError(
            "parallel='sp' needs AMTConfig.sequence_parallel=True")
    data = mesh.shape["data"]
    if batch_size % data:
        raise ValueError(
            f"batch_size {batch_size} not divisible by the "
            f"data-axis size {data}")
    if parallel == "pp" and (
            batch_size % n_microbatches
            or (batch_size // n_microbatches) % data):
        raise ValueError(
            f"pp needs batch_size divisible by n_microbatches "
            f"({n_microbatches}) and each microbatch divisible by the "
            f"data axis ({data}); got {batch_size}")


def train_amt(model_cfg: AMTConfig, tcfg: TrainConfig, loop: LoopConfig,
              train_ds, val_ds, *, drop_loss: bool = False, device=None,
              mesh=None, parallel: str = "dp",
              n_microbatches: int = 4) -> TrainState:
    """A full AMT training run (CUDA unless ``device`` says otherwise;
    raises without CUDA). Returns the final state; writes
    ``results.csv``, ``weights/best_loss_weights``,
    ``weights/epoch_NNNN`` and ``best_epochs.txt`` under
    ``loop.output_dir``. ``mesh`` (``parallel.create_mesh``; every rank
    calls): train with ``parallel`` "dp" | "tp" | "sp" | "pp" on it (the
    state returned is this rank's shares; the checkpoints are whole)."""
    if mesh is not None:
        check_mesh_run(model_cfg, loop.batch_size, mesh, parallel,
                       n_microbatches)
        device = mesh.device
    main = mesh is None or mesh.is_main
    if not main:
        loop = dataclasses.replace(loop, log_fn=lambda msg: None,
                                   profile_steps=0, tensorboard_dir=None)
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

    plan = None
    if mesh is None:
        train_step = make_amt_train_step(tcfg, drop_loss=drop_loss)
    else:
        from ..parallel.shard import shard_train_state_
        plan = shard_train_state_(state, mesh, parallel)
        if parallel == "pp":
            from .pp import make_amt_pp_train_step
            train_step = make_amt_pp_train_step(
                model_cfg, tcfg, mesh, n_microbatches=n_microbatches,
                drop_loss=drop_loss)
        else:
            train_step = make_amt_train_step(tcfg, drop_loss=drop_loss,
                                             mesh=mesh)
    eval_step = make_amt_eval_step(tcfg, mesh)
    sched = noam_schedule(model_cfg.d_model, tcfg.warmup_steps)
    save = lambda path: ckpt.save_checkpoint(path, state, mesh, plan)

    if main:
        _csv_header(results_file, CSV_HEADER)
    best_eval_loss, best_epoch = float("inf"), -1
    loader = PrefetchLoader(train_ds, loop.batch_size, shuffle=True,
                            seed=loop.seed)
    profiler = _make_profiler(loop, dev)
    tb = _make_tb(loop)
    for epoch in range(start_epoch, loop.epochs):
        t0 = time.time()
        batches = loader if mesh is None else _local_batches(
            loader, loop.batch_size, mesh, loop.log_fn)
        state, _ = _epoch_pass(train_step, state, batches, dev, profiler)
        train_m = (_eval_pass(eval_step, state, train_ds, loop.batch_size,
                              mesh, loop.log_fn)
                   if loop.eval_train_subset else {})
        eval_m = _eval_pass(eval_step, state, val_ds, loop.batch_size,
                            mesh, loop.log_fn)
        lr = float(sched(state.step)) if tcfg.lr is None else tcfg.lr
        loop.log_fn(
            f"epoch {epoch + 1}/{loop.epochs} "
            f"val_loss={eval_m['loss']:.4f} h1={eval_m['hits@1']:.4f} "
            f"h3={eval_m['hits@3']:.4f} h5={eval_m['hits@5']:.4f} "
            f"({time.time() - t0:.1f}s)")
        if tb is not None:
            # the JAX loop's tags and 1-based step (train/loop.py:367-377)
            tb.add_scalar("Avg_CE_loss/eval", eval_m["loss"], epoch + 1)
            tb.add_scalar("Avg_CE_loss_chord/eval", eval_m["loss_chord"],
                          epoch + 1)
            tb.add_scalar("Avg_CE_loss_emotion/eval",
                          eval_m["loss_emotion"], epoch + 1)
            tb.add_scalar("Learn_rate/train", lr, epoch + 1)
            tb.flush()

        if eval_m["loss"] < best_eval_loss:
            best_eval_loss, best_epoch = eval_m["loss"], epoch + 1
            save(os.path.join(weights_dir, "best_loss_weights"))
            if main:
                with open(os.path.join(loop.output_dir, "best_epochs.txt"),
                          "w") as f:
                    f.write(f"Best val loss epoch: {best_epoch}\n"
                            f"Best val loss: {best_eval_loss}\n")
        if (epoch + 1) % loop.weight_modulus == 0:
            save(os.path.join(weights_dir, f"epoch_{epoch + 1:04d}"))
        if not main:
            continue
        _csv_row(results_file, [
            epoch + 1, lr,
            train_m.get("loss", ""), train_m.get("loss_chord", ""),
            train_m.get("loss_emotion", ""),
            train_m.get("hits@1", ""), train_m.get("hits@3", ""),
            train_m.get("hits@5", ""),
            eval_m["loss"], eval_m["loss_chord"], eval_m["loss_emotion"],
            eval_m["hits@1"], eval_m["hits@3"], eval_m["hits@5"],
        ])
    if tb is not None:
        tb.close()
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
    profiler = _make_profiler(loop, dev)
    for epoch in range(loop.epochs):
        state, train_rows = _epoch_pass(train_step, state, loader, dev,
                                        profiler)
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
    profiler = _make_profiler(loop, dev)
    for epoch in range(loop.epochs):
        t0 = time.time()
        state, _ = _epoch_pass(train_step, state, loader, dev, profiler)
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
