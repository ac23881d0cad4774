"""CLI: evaluate a trained regression model on the test split
(``python -m video2music_tpu_torch.cli.evaluate_regression``).

The JAX package's CLI on the port (reference: ``evaluate_regression.py:
33-114``): a checkpoint of the port's format (e.g.
``weights/best_rmse_weights`` of ``train_regression``), per-head RMSE
(note density, loudness) + instrument BCE on the test split from the
port's eval step, written to ``eval_results.json``. ``-device``: ``cuda``
unless given; without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..core.config import RegressionConfig
from ..data import create_vevo_datasets
from ..data.dataset import batches as make_batches
from ..data.loader import device_prefetch
from ..train.step import make_regression_eval_step, resolve_device
from .evaluate import load_model
from .train_amt import add_device_flag


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate VideoRegression on the test split")
    p.add_argument("-dataset_dir", default="./dataset")
    p.add_argument("-model_weights", required=True)
    p.add_argument("-regModel", default="bilstm")
    p.add_argument("-n_layers", type=int, default=2)
    p.add_argument("-d_model", type=int, default=64)
    p.add_argument("-dim_feedforward", type=int, default=1024)
    p.add_argument("-batch_size", type=int, default=8)
    p.add_argument("-output_dir", default="./eval_out_reg")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    _, _, test_ds = create_vevo_datasets(dataset_root=args.dataset_dir)
    if not len(test_ds):
        raise SystemExit(f"no complete samples under {args.dataset_dir}")
    sample = test_ds[0]
    cfg = RegressionConfig(
        reg_model=args.regModel, n_layers=args.n_layers,
        d_model=args.d_model, d_hidden=args.dim_feedforward, dropout=0.0,
        total_vf_dim=(sample["semantic"].shape[-1]
                      + sample["emotion"].shape[-1]))
    model = load_model(cfg, args.model_weights, "VideoRegression", device)

    eval_step = make_regression_eval_step()
    rows = [eval_step(model, b) for b in device_prefetch(
        make_batches(test_ds, args.batch_size, shuffle=False), device)]
    se_nd = sum(float(r["se_note_density"]) for r in rows)
    se_ln = sum(float(r["se_loudness"]) for r in rows)
    n = sum(float(r["count"]) for r in rows)
    metrics = {
        "rmse_note_density": float(np.sqrt(se_nd / max(n, 1.0))),
        "rmse_loudness": float(np.sqrt(se_ln / max(n, 1.0))),
        "bce_instrument": float(np.mean([float(r["bce_instrument"])
                                         for r in rows])),
        "loss": float(np.mean([float(r["loss"]) for r in rows])),
    }
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "eval_results.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
