"""CLI: train the VideoRegression model
(``python -m video2music_tpu_torch.cli.train_regression``).

The JAX package's CLI on the port, plus ``-device`` (``cuda`` unless
given; without CUDA it raises). Flags mirror ``parse_train_reg_args``
(reference: ``utilities/argument_reg_funcs.py:4-40``); the live feature
set is semantic + emotion only (reference: ``train_regression.py:92-109``).
"""

from __future__ import annotations

import argparse

from ..core.config import RegressionConfig, TrainConfig
from ..data import create_vevo_datasets
from ..train.loop import LoopConfig, train_regression
from ..train.step import resolve_device
from .train_amt import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train VideoRegression on one "
                                            "GPU")
    p.add_argument("-dataset_dir", default="./dataset")
    p.add_argument("-output_dir", default="./saved_models/REG")
    p.add_argument("-regModel", default="bilstm")
    p.add_argument("-epochs", type=int, default=50)
    p.add_argument("-batch_size", type=int, default=32)
    p.add_argument("-lr", type=float, default=1e-4)
    p.add_argument("-optimizer", default="adam")
    p.add_argument("-n_layers", type=int, default=2)
    p.add_argument("-d_model", type=int, default=64)
    p.add_argument("-dim_feedforward", type=int, default=1024)
    p.add_argument("-dropout", type=float, default=0.1)
    p.add_argument("-augmentation", action="store_true")
    p.add_argument("-use_KAN", action="store_true")
    p.add_argument("-continue_weights", default=None)
    p.add_argument("-seed", type=int, default=0)
    add_device_flag(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    train_ds, val_ds, _ = create_vevo_datasets(
        dataset_root=args.dataset_dir, augmentation=args.augmentation)
    if not len(train_ds):
        raise SystemExit(f"no complete samples under {args.dataset_dir}")
    sample = train_ds[0]
    cfg = RegressionConfig(
        reg_model=args.regModel, n_layers=args.n_layers,
        d_model=args.d_model, d_hidden=args.dim_feedforward,
        dropout=args.dropout, use_kan=args.use_KAN,
        total_vf_dim=(sample["semantic"].shape[-1]
                      + sample["emotion"].shape[-1]))
    tcfg = TrainConfig(batch_size=args.batch_size, epochs=args.epochs,
                       lr=args.lr, optimizer=args.optimizer, seed=args.seed)
    loop = LoopConfig(epochs=args.epochs, batch_size=args.batch_size,
                      output_dir=args.output_dir,
                      continue_from=args.continue_weights, seed=args.seed)
    return train_regression(cfg, tcfg, loop, train_ds, val_ds, device=device)


if __name__ == "__main__":
    main()
