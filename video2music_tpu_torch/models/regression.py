"""VideoRegression with the Mamba-family backbones (counterpart of
models/regression.py): [semantic | emotion] -> in_proj -> backbone ->
Dense(2) note-density/loudness regressor and sigmoid(Dense(40)) instrument
classifier. The backbones:

  mamba / mamba+        Mamba: residual Mamba (/ mamba+) blocks
  moemamba              MoEMamba: d_state = d_hidden, d_conv 8, shared MoE
  bimamba               BiMambaEncoder of v0 layers
  bimamba+              BiMambaEncoder of V1 layers (mamba+ blocks)
  moe_bimamba+          the same with a MoE FFN, no shared expert
  sharedmoe_bimamba+    the same with a shared-expert MoE FFN

each MoE with 6 GLU experts of width 2 d_model + 1, top-2
(models/regression.py:61-74); ``use_kan`` makes the Mamba and MoEMamba
projections KAN layers (the bidirectional encoders do not pass it on, as
in the JAX package). The RNN, CNN-GRU and minGRU backbones are not ported
yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import constants as C
from ..core.config import MambaBackboneConfig, MoEConfig, RegressionConfig

from ..ops.attention import not_ported
from ..ops.moe import MoELayer
from .bimamba import BiMambaEncoder
from .mamba import Mamba, MoEMamba

NOT_PORTED = ("bilstm", "bigru", "lstm", "gru", "cnngru", "cnnbigru",
              "mingru")


def _moe_maker(cfg: RegressionConfig, shared: bool):
    moe_cfg = MoEConfig(n_experts=6, n_experts_per_token=2, expert="glu",
                        shared_expert=shared)
    return lambda: MoELayer(moe_cfg, cfg.d_model, 2 * cfg.d_model + 1,
                            cfg.dropout)


def make_backbone(cfg: RegressionConfig) -> nn.Module:
    rm = cfg.reg_model
    if rm in NOT_PORTED:
        raise not_ported(f"the {rm!r} regression backbone",
                         "Queue 1 item 12, RNN and minGRU backbones")
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
        self.regressor = nn.Linear(cfg.d_model, 2)
        self.classifier = nn.Linear(cfg.d_model, C.INSTRUMENT_SIZE)

    def forward(self, semantic, scene_offset, motion, emotion):
        """Live-path features are semantic + emotion only; returns
        (loudness/note density (B, L, 2), instrument probs (B, L, 40))."""
        del scene_offset, motion
        vf = torch.cat([semantic, emotion.to(semantic.dtype)], dim=-1)
        out = self.backbone(self.in_proj(vf))
        return self.regressor(out), torch.sigmoid(self.classifier(out))
