"""CLI: a reference checkpoint into a port checkpoint
(``python -m video2music_tpu_torch.cli.convert_reference_checkpoint``).

    python -m video2music_tpu_torch.cli.convert_reference_checkpoint \\
        --weights best_loss_weights.pickle --kind amt_v2 \\
        --out weights/best_loss_weights

The counterpart of the JAX package's tools/convert_reference_checkpoint.py,
which writes orbax. The reference's torch ``state_dict`` pickle
(``torch.load``) goes through train/convert.py (``amt``: the base AMT;
``amt_v2``: the V2 family, its MoE balancing buffers through
``convert_reference_moe_state``; ``regression``: the RNN backbones), then
``weights.amt_from_jax`` / ``regression_from_jax``, into the model of the
config the state dict's shapes give (strict ``load_state_dict``), and out
through train/checkpoint.py ``save_checkpoint`` (a fresh optimizer, step
0). ``Video2music(amt_checkpoint=...)`` / ``reg_checkpoint=...`` and the
generate CLI's ``-amt_weights`` / ``-reg_weights`` read the file as it is.
``-device``: where the model is built (``cuda`` unless given; without
CUDA it raises).

The config: d_model, d_ff, the video feature width (and, for the base
AMT, the RPR table's length and head size; for 2.0, the learned position
tables' lengths) come from the weights' shapes; the head count of a V2
model (which no weight's shape gives) and the expert count are the
reference's 8 and 6. A V2 state dict with learned position tables is 2.0,
any other 2.2 (2.1 has 2.2's weights).
"""

from __future__ import annotations

import argparse
import re

import torch

from ..core.config import RegressionConfig, TrainConfig, amt_config
from ..train.checkpoint import save_checkpoint
from ..train.convert import (convert_reference_amt, convert_reference_amt_v2,
                             convert_reference_moe_state,
                             convert_reference_regression)
from ..train.step import create_train_state, resolve_device
from ..weights import amt_from_jax, regression_from_jax
from .train_amt import add_device_flag


def _shape(sd, key):
    return tuple(sd[key].shape)


def amt_reference_config(sd, kind: str, n_layers: int):
    """The AMTConfig of a reference AMT state dict (module docstring)."""
    D = _shape(sd, "embedding_root.weight")[1]
    kw = dict(n_layers=n_layers, d_model=D,
              total_vf_dim=_shape(sd, "Linear_vis.weight")[1],
              scene_embed="scene_embedding.weight" in sd,
              separated="Wout.weight" not in sd)
    if kind == "amt":
        Lq, hd = _shape(sd, "transformer.decoder.layers.0.self_attn.Er")
        kw.update(d_ff=_shape(sd, "transformer.encoder.layers.0.linear1"
                                  ".weight")[0],
                  num_heads=D // hd, max_seq_chord=Lq)
        return amt_config(None, **kw)
    kw["d_ff"] = _shape(sd, "transformer.encoder.layers.0.ff.linear1"
                            ".weight")[0]
    if "positional_embedding.weight" in sd:
        kw.update(max_seq_chord=_shape(sd, "positional_embedding.weight")[0],
                  max_seq_video=_shape(
                      sd, "positional_embedding_video.weight")[0])
        return amt_config("2.0", **kw)
    return amt_config("2.2", **kw)


def regression_reference_config(sd, reg_model: str) -> RegressionConfig:
    """The RegressionConfig of a reference regression state dict: the
    width and the video feature width from ``in_proj``, the depth from the
    RNN's ``weight_ih_l{k}`` entries."""
    d_model, vf = _shape(sd, "in_proj.0.weight")
    layers = {int(m.group(1)) for k in sd
              if (m := re.search(r"weight_ih_l(\d+)$", k))}
    return RegressionConfig(reg_model=reg_model, n_layers=len(layers),
                            d_model=d_model, total_vf_dim=vf)


def convert(sd, kind: str, n_layers: int = 6, reg_model: str = "bilstm"):
    """(config, port state dict) of a reference state dict of ``kind``."""
    if kind == "amt":
        return (amt_reference_config(sd, kind, n_layers),
                amt_from_jax(convert_reference_amt(sd, n_layers)))
    if kind == "amt_v2":
        return (amt_reference_config(sd, kind, n_layers),
                amt_from_jax(convert_reference_amt_v2(sd, n_layers),
                             convert_reference_moe_state(sd, n_layers)))
    if kind == "regression":
        return (regression_reference_config(sd, reg_model),
                regression_from_jax(convert_reference_regression(
                    sd, reg_model)))
    raise ValueError(f"unknown kind {kind!r}")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a reference state_dict pickle into a port "
                    "checkpoint")
    p.add_argument("--weights", required=True)
    p.add_argument("--kind", choices=["amt", "amt_v2", "regression"],
                   default="amt")
    p.add_argument("--n_layers", type=int, default=6)
    p.add_argument("--reg_model", default="bilstm")
    p.add_argument("--out", required=True)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    sd = torch.load(args.weights, map_location="cpu", weights_only=True)
    cfg, weights = convert(sd, args.kind, args.n_layers, args.reg_model)
    state = create_train_state(cfg, TrainConfig(), device=device)
    state.model.load_state_dict(weights)
    save_checkpoint(args.out, state)
    print(f"wrote port checkpoint {args.out} ({type(state.model).__name__}, "
          f"{args.kind}, d_model {cfg.d_model}, {cfg.n_layers} layers)")


if __name__ == "__main__":
    main()
