"""CLI: train the AMT (``python -m video2music_tpu_torch.cli.train_amt``).

The JAX package's CLI on the port (its flags, defaults and output tree:
``results.csv``, ``weights/``, ``best_epochs.txt``, TensorBoard scalars
under ``<output_dir>/tensorboard`` unless ``-no_tensorboard``), plus
``-device`` (``cuda`` unless given; without CUDA it raises). Flag names
mirror the reference's ``parse_train_args``
(reference: ``utilities/argument_funcs.py:22-75``, dashes kept).

Several GPUs: ``-mesh DxM -parallel dp|tp|sp|pp [-microbatches N]``.
From a plain shell the command starts its D*M ranks itself (fresh
processes on this machine, ``parallel.launch``); under ``torchrun`` (or
any launcher that sets ``RANK`` / ``WORLD_SIZE``) it joins the world it
is given. ``-device cuda`` runs NCCL, one GPU per rank; ``-device cpu``
runs gloo. ``-parallel sp`` sets ``sequence_parallel``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from ..core.config import MusicTransformerConfig, TrainConfig, amt_config
from ..data import create_vevo_datasets
from ..train.loop import LoopConfig, train_amt, train_music_transformer
from ..train.step import resolve_device


def total_vf_dim(sample, motion_type: int) -> int:
    """768 semantic + 1 scene + {1,512,768} motion + emotion dim
    (reference: train.py:110-130)."""
    sem = sample["semantic"].shape[-1]
    emo = sample["emotion"].shape[-1]
    motion = {0: 1, 1: 512, 2: 768}[motion_type]
    return sem + 1 + motion + emo


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("-device", default="cuda",
                   help="torch device; 'cuda' (the default) raises without "
                        "CUDA, 'cpu' runs the kernels' plain versions")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the AMT")
    p.add_argument("-dataset_dir", default="./dataset")
    p.add_argument("-output_dir", default="./saved_models/AMT")
    p.add_argument("-music_gen_version", default=None,
                   help="None=base AMT; '1.1'..'3.2' fork variants")
    p.add_argument("-epochs", type=int, default=50)
    p.add_argument("-batch_size", type=int, default=32)
    p.add_argument("-lr", type=float, default=None)
    p.add_argument("-ce_smoothing", type=float, default=None)
    p.add_argument("-optimizer", default="adam")
    p.add_argument("-auxiliary_loss", action="store_true")
    p.add_argument("-drop_loss", action="store_true")
    p.add_argument("-augmentation", action="store_true")
    p.add_argument("-motion_type", type=int, default=0)
    p.add_argument("-n_layers", type=int, default=6)
    p.add_argument("-num_heads", type=int, default=8)
    p.add_argument("-d_model", type=int, default=512)
    p.add_argument("-dim_feedforward", type=int, default=1024)
    p.add_argument("-dropout", type=float, default=0.1)
    p.add_argument("-weight_modulus", type=int, default=1)
    p.add_argument("-continue_weights", default=None)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-music_only", action="store_true",
                   help="train the no-video MusicTransformer baseline "
                        "(reference IS_VIDEO=False)")
    p.add_argument("-moe_dispatch", default="dense",
                   choices=["dense", "capacity"],
                   help="MoE expert dispatch for batched calls: 'dense' "
                        "(exact, default) or 'capacity' (per-expert "
                        "buffers of capacity-factor slots)")
    p.add_argument("-moe_capacity_factor", type=float, default=1.25)
    p.add_argument("-mesh", default=None, metavar="DATAxMODEL",
                   help="multi-GPU mesh, e.g. '2x2' (data x model ranks: "
                        "started here from a shell, joined under "
                        "torchrun); single device when unset")
    p.add_argument("-parallel", default="dp",
                   choices=["dp", "tp", "sp", "pp"],
                   help="strategy on the mesh: dp (batch; EP expert "
                        "stacks), tp (+Megatron column/row weights), sp "
                        "(tp + sequence-parallel residual stream), pp "
                        "(GPipe pipeline stages, homogeneous stacks only)")
    p.add_argument("-profile", type=int, default=0, metavar="N",
                   help="trace train steps 1..N (step 0 warms up) with "
                        "torch.profiler into -profile_dir (a Chrome trace)")
    p.add_argument("-profile_dir", default="./profile")
    p.add_argument("-no_tensorboard", action="store_true",
                   help="disable the TensorBoard scalar stream (written by "
                        "the first-party event writer in obs/tensorboard.py "
                        "to <output_dir>/tensorboard; on by default like "
                        "the reference train.py:91-96)")
    p.add_argument("-microbatches", type=int, default=4,
                   help="pipeline microbatches per step (-parallel pp)")
    add_device_flag(p)
    return p


def _mesh_shape(text: str):
    data, model = (int(v) for v in text.lower().split("x"))
    return data, model


def _rank_main(argv):
    """One rank of a world this command started."""
    main(argv)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.mesh and args.parallel != "dp":
        raise SystemExit(
            f"-parallel {args.parallel} requires -mesh (e.g. -mesh 4x2); "
            "without a mesh the run would silently train single-device")
    mesh = None
    if args.mesh:
        shape = _mesh_shape(args.mesh)
        backend = "nccl" if args.device.startswith("cuda") else "gloo"
        if "RANK" not in os.environ:
            # a plain shell: start the world's ranks, each this command
            from ..parallel.launch import spawn
            import tempfile
            world = shape[0] * shape[1]
            with tempfile.TemporaryDirectory() as work:
                # CPU ranks share this machine's cores
                spawn("video2music_tpu_torch.cli.train_amt:_rank_main",
                      world, sys.argv[1:] if argv is None else list(argv),
                      workdir=work,
                      threads=(max(1, (os.cpu_count() or 1) // world)
                               if backend == "gloo" else None))
            return None
        from ..parallel import create_mesh
        mesh = create_mesh(shape, backend=backend,
                           device=("cuda" if backend == "nccl"
                                   else args.device))
        device = mesh.device
    else:
        device = resolve_device(args.device)
    train_ds, val_ds, _ = create_vevo_datasets(
        dataset_root=args.dataset_dir, motion_type=args.motion_type,
        augmentation=args.augmentation)
    if not len(train_ds):
        raise SystemExit(f"no complete samples under {args.dataset_dir}")
    tcfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
        ce_smoothing=args.ce_smoothing, optimizer=args.optimizer,
        auxiliary_loss=args.auxiliary_loss, seed=args.seed)
    loop = LoopConfig(epochs=args.epochs, batch_size=args.batch_size,
                      output_dir=args.output_dir,
                      weight_modulus=args.weight_modulus,
                      eval_train_subset=not args.augmentation,
                      continue_from=args.continue_weights, seed=args.seed,
                      profile_steps=args.profile,
                      profile_dir=args.profile_dir,
                      tensorboard_dir=(
                          None if args.no_tensorboard else
                          os.path.join(args.output_dir, "tensorboard")))
    if args.music_only:
        if mesh is not None:
            raise SystemExit("-music_only trains on one device; drop -mesh")
        mcfg = MusicTransformerConfig(
            n_layers=args.n_layers, num_heads=args.num_heads,
            d_model=args.d_model, d_ff=args.dim_feedforward,
            dropout=args.dropout)
        return train_music_transformer(mcfg, tcfg, loop, train_ds, val_ds,
                                       device=device)
    cfg = amt_config(
        args.music_gen_version, n_layers=args.n_layers,
        num_heads=args.num_heads, d_model=args.d_model,
        d_ff=args.dim_feedforward, dropout=args.dropout,
        total_vf_dim=total_vf_dim(train_ds[0], args.motion_type))
    if args.moe_dispatch != "dense":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=args.moe_dispatch,
            capacity_factor=args.moe_capacity_factor))
    if mesh is not None and args.parallel == "sp":
        cfg = dataclasses.replace(cfg, sequence_parallel=True)
    return train_amt(cfg, tcfg, loop, train_ds, val_ds,
                     drop_loss=args.drop_loss, device=device, mesh=mesh,
                     parallel=args.parallel,
                     n_microbatches=args.microbatches)


if __name__ == "__main__":
    main()
