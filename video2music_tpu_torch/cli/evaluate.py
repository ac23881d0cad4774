"""CLI: evaluate a trained AMT on the test split
(``python -m video2music_tpu_torch.cli.evaluate``).

The JAX package's CLI on the port: a checkpoint of the port's format
(train/checkpoint.py, e.g. ``weights/best_loss_weights`` of
``train_amt``; its weights are read), loss, accuracy, hits@1/3/5 and
correspondence on the test split from the port's eval step
(``eval_results.json``), optionally the chord / root / quality confusion
matrices as ``.npy`` (reference: ``utilities/run_model_vevo.py:454-566``)
and the MoE layers' expert-emotion counts as JSON and heatmaps
(``-expert_plots``, obs/logging.py). ``-device``: ``cuda`` unless given;
without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..core import constants as C
from ..core.config import TrainConfig, amt_config
from ..data import create_vevo_datasets
from ..data.dataset import batches as make_batches
from ..data.loader import device_prefetch
from ..train.checkpoint import load_weights
from ..train.loop import _mean_metrics
from ..train.step import (MODEL_INPUTS, build_model, make_amt_eval_step,
                          resolve_device)
from .train_amt import add_device_flag, total_vf_dim


def load_model(cfg, path: str, kind: str, device):
    """The model of ``cfg`` on ``device`` in eval mode, with the weights of
    the port checkpoint at ``path`` (a ``kind`` model)."""
    model = build_model(cfg)
    model.load_state_dict(load_weights(path, model_class=kind))
    return model.to(device).eval()


def _inputs(batch):
    return tuple(batch[k] for k in MODEL_INPUTS)


@torch.no_grad()
def confusion_matrices(model, dataset, batch_size=8):
    """(chord 159x159, root 15x15, quality 16x16) count matrices of the
    model's argmax over non-PAD targets (reference: run_model_vevo.py:
    454-566)."""
    from ..core.vocab import chord_to_root_attr_tables
    root_tab, attr_tab = chord_to_root_attr_tables()
    device = next(model.parameters()).device

    cm = np.zeros((C.CHORD_SIZE, C.CHORD_SIZE), np.int64)
    for batch in device_prefetch(make_batches(dataset, batch_size,
                                              shuffle=False), device):
        pred = model(*_inputs(batch)).argmax(dim=-1).cpu().numpy()
        tgt = batch["tgt"].cpu().numpy()
        mask = tgt != C.CHORD_PAD
        np.add.at(cm, (tgt[mask], pred[mask]), 1)
    cm_root = np.zeros((15, 15), np.int64)
    cm_attr = np.zeros((16, 16), np.int64)
    ids = np.arange(C.CHORD_SIZE)
    np.add.at(cm_root, (root_tab[ids][:, None].repeat(C.CHORD_SIZE, 1),
                        root_tab[ids][None, :].repeat(C.CHORD_SIZE, 0)), cm)
    np.add.at(cm_attr, (attr_tab[ids][:, None].repeat(C.CHORD_SIZE, 1),
                        attr_tab[ids][None, :].repeat(C.CHORD_SIZE, 0)), cm)
    return cm, cm_root, cm_attr


@torch.no_grad()
def expert_emotion_counts(model, dataset, batch_size=8):
    """Run the eval forward over ``dataset`` with the MoE layers counting
    their selections by dominant emotion; returns the model's MoE metrics
    (obs.collect_moe_metrics), the emotion counts summed over batches."""
    from ..obs import collect_moe_metrics, reset_moe_metrics
    device = next(model.parameters()).device
    reset_moe_metrics(model)
    for b in device_prefetch(make_batches(dataset, batch_size,
                                          shuffle=False), device):
        model(*_inputs(b), count_emotions=True)
    return collect_moe_metrics(model)


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate AMT on the test split")
    p.add_argument("-dataset_dir", default="./dataset")
    p.add_argument("-model_weights", required=True)
    p.add_argument("-music_gen_version", default=None)
    p.add_argument("-motion_type", type=int, default=0)
    p.add_argument("-n_layers", type=int, default=6)
    p.add_argument("-num_heads", type=int, default=8)
    p.add_argument("-d_model", type=int, default=512)
    p.add_argument("-dim_feedforward", type=int, default=1024)
    p.add_argument("-batch_size", type=int, default=8)
    p.add_argument("-output_dir", default="./eval_out")
    p.add_argument("-ce_smoothing", type=float, default=None,
                   help="must match training for comparable loss values")
    p.add_argument("-confusion", action="store_true",
                   help="also save chord/root/quality confusion .npy files")
    p.add_argument("-expert_plots", action="store_true",
                   help="save MoE expert-emotion count json + heatmaps "
                        "(reference: third_party/log_experts.py)")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    _, _, test_ds = create_vevo_datasets(dataset_root=args.dataset_dir,
                                         motion_type=args.motion_type)
    if not len(test_ds):
        raise SystemExit(f"no complete samples under {args.dataset_dir}")
    cfg = amt_config(args.music_gen_version, n_layers=args.n_layers,
                     num_heads=args.num_heads, d_model=args.d_model,
                     d_ff=args.dim_feedforward, dropout=0.0,
                     total_vf_dim=total_vf_dim(test_ds[0], args.motion_type))
    model = load_model(cfg, args.model_weights, "VideoMusicTransformer",
                       device)
    tcfg = TrainConfig(ce_smoothing=args.ce_smoothing)

    eval_step = make_amt_eval_step(tcfg)
    rows = [eval_step(model, b) for b in device_prefetch(
        make_batches(test_ds, args.batch_size, shuffle=False), device)]
    metrics = _mean_metrics(rows)

    if args.expert_plots:
        from ..obs import plot_expert_emotion_heatmaps, save_expert_emotion
        acc = expert_emotion_counts(model, test_ds, args.batch_size)
        if any("expert_emotion_counts" in v for v in acc.values()):
            os.makedirs(args.output_dir, exist_ok=True)
            save_expert_emotion(acc, out_dir=args.output_dir)
            plot_expert_emotion_heatmaps(acc, out_dir=args.output_dir)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "eval_results.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2))

    if args.confusion:
        cm, cm_root, cm_attr = confusion_matrices(model, test_ds,
                                                  args.batch_size)
        np.save(os.path.join(args.output_dir, "confusion_chord.npy"), cm)
        np.save(os.path.join(args.output_dir, "confusion_root.npy"), cm_root)
        np.save(os.path.join(args.output_dir, "confusion_quality.npy"),
                cm_attr)
    return metrics


if __name__ == "__main__":
    main()
