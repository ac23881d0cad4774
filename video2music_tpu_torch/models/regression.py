"""VideoRegression over the fourteen backbones of the JAX package
(counterpart of models/regression.py): [semantic | emotion] -> in_proj
(dropout in training) -> backbone -> Dense(2) note-density/loudness
regressor and sigmoid(Dense(40)) instrument classifier, both as wide as
the backbone's output (2 d_model for a bidirectional RNN). The backbones:

  bilstm / bigru / lstm / gru   RNNStack (cuDNN nn.LSTM / nn.GRU)
  cnngru / cnnbigru     CNNGRU: Conv1d(k 7, same) + SiLU + dropout, then GRU
  mamba / mamba+        Mamba: residual Mamba (/ mamba+) blocks
  moemamba              MoEMamba: d_state = d_hidden, d_conv 8, shared MoE
  bimamba               BiMambaEncoder of v0 layers
  bimamba+              BiMambaEncoder of V1 layers (mamba+ blocks)
  moe_bimamba+          the same with a MoE FFN, no shared expert
  sharedmoe_bimamba+    the same with a shared-expert MoE FFN

each MoE with 6 GLU experts of width 2 d_model + 1, top-2
(models/regression.py:61-74); ``use_kan`` makes the Mamba and MoEMamba
projections KAN layers (the bidirectional encoders do not pass it on, as
in the JAX package);

  mingru                _MinGRUBackbone: RMSNorm + minGRU + FF blocks.

``forward(..., generator=...)`` is a training call: the input projection's
dropout and every backbone dropout draw from that generator (the minGRU
blocks have none).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..core import constants as C
from ..core.config import MambaBackboneConfig, MoEConfig, RegressionConfig
from ..ops.dropout import dropout
from ..ops.moe import MoELayer
from .bimamba import BiMambaEncoder
from .mamba import Mamba, MoEMamba
from .mingru import _MinGRUBlock
from .rnn import RNNStack

BACKBONES = (
    "bilstm", "bigru", "lstm", "gru", "cnngru", "cnnbigru",
    "mamba", "mamba+", "moemamba", "bimamba", "bimamba+",
    "moe_bimamba+", "sharedmoe_bimamba+", "mingru",
)


class CNNGRU(nn.Module):
    """Conv1d(k=7, same) + SiLU + dropout -> GRU (reference :86-104)."""

    def __init__(self, d_model: int, n_layers: int = 1,
                 dropout_rate: float = 0.1, bidirectional: bool = False):
        super().__init__()
        self.cnn = nn.Conv1d(d_model, d_model, 7, padding=3)
        self.dropout_rate = dropout_rate
        self.gru = RNNStack("gru", d_model, d_model, n_layers,
                            bidirectional, dropout_rate)
        self.out_dim = self.gru.out_dim

    def forward(self, x, generator=None):                  # (B, L, d_model)
        h = F.silu(self.cnn(x.transpose(1, 2)).transpose(1, 2))
        return self.gru(dropout(h, self.dropout_rate, generator), generator)


class _MinGRUBackbone(nn.Module):
    """Norm + minGRU (expansion 1.5) + FF (4 d_model, tanh GELU) residual
    blocks at (B, L, d_model), no logits head."""

    def __init__(self, d_model: int, depth: int = 2):
        super().__init__()
        self.blocks = nn.ModuleList(_MinGRUBlock(d_model, 1.5, 4 * d_model)
                                    for _ in range(depth))

    def forward(self, x, generator=None):
        del generator  # the minGRU blocks have no dropout
        for block in self.blocks:
            x = block(x)
        return x


def _moe_maker(cfg: RegressionConfig, shared: bool):
    moe_cfg = MoEConfig(n_experts=6, n_experts_per_token=2, expert="glu",
                        shared_expert=shared)
    return lambda: MoELayer(moe_cfg, cfg.d_model, 2 * cfg.d_model + 1,
                            cfg.dropout)


def make_backbone(cfg: RegressionConfig) -> nn.Module:
    rm = cfg.reg_model
    if rm in ("bilstm", "bigru", "lstm", "gru"):
        return RNNStack("lstm" if "lstm" in rm else "gru", cfg.d_model,
                        cfg.d_model, cfg.n_layers,
                        bidirectional=rm.startswith("bi"),
                        dropout_rate=cfg.dropout)
    if rm in ("cnngru", "cnnbigru"):
        return CNNGRU(cfg.d_model, cfg.n_layers, cfg.dropout,
                      bidirectional=rm == "cnnbigru")
    if rm == "mingru":
        return _MinGRUBackbone(cfg.d_model, cfg.n_layers)
    mcfg = lambda **kw: MambaBackboneConfig(d_model=cfg.d_model,
                                            dropout=cfg.dropout, bias=True,
                                            **kw)
    if rm in ("mamba", "mamba+"):
        return Mamba(mcfg(use_version=int(rm == "mamba+")), cfg.n_layers,
                     cfg.use_kan)
    if rm == "moemamba":
        return MoEMamba(mcfg(d_state=cfg.d_hidden, d_conv=8), cfg.n_layers,
                        cfg.use_kan, _moe_maker(cfg, shared=True))
    if rm == "bimamba":
        return BiMambaEncoder(mcfg(), cfg.d_hidden, cfg.n_layers)
    if rm in ("bimamba+", "moe_bimamba+", "sharedmoe_bimamba+"):
        maker = None if rm == "bimamba+" else _moe_maker(
            cfg, shared=rm.startswith("shared"))
        return BiMambaEncoder(mcfg(use_version=1), cfg.d_hidden,
                              cfg.n_layers, moe_maker=maker)
    raise ValueError(f"unknown regression backbone {rm!r}")


class VideoRegression(nn.Module):
    def __init__(self, cfg: RegressionConfig):
        super().__init__()
        self.cfg = cfg
        self.in_proj = nn.Linear(cfg.total_vf_dim, cfg.d_model)
        self.backbone = make_backbone(cfg)
        d_out = getattr(self.backbone, "out_dim", cfg.d_model)
        self.regressor = nn.Linear(d_out, 2)
        self.classifier = nn.Linear(d_out, C.INSTRUMENT_SIZE)

    def forward(self, semantic, scene_offset, motion, emotion,
                generator=None):
        """Live-path features are semantic + emotion only; returns
        (loudness/note density (B, L, 2), instrument probs (B, L, 40)).
        ``generator``: a torch.Generator on the inputs' device makes this a
        training call."""
        del scene_offset, motion
        vf = torch.cat([semantic, emotion.to(semantic.dtype)], dim=-1)
        vf = dropout(self.in_proj(vf), self.cfg.dropout, generator)
        out = self.backbone(vf, generator)
        return self.regressor(out), torch.sigmoid(self.classifier(out))
