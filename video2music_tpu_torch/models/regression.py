"""VideoRegression with the bimamba+ backbone (counterpart of
models/regression.py): [semantic | emotion] -> in_proj -> BiMambaEncoder
(mamba+ blocks) -> Dense(2) note-density/loudness regressor and
sigmoid(Dense(40)) instrument classifier. The other 13 backbones are not
ported yet."""

from __future__ import annotations

import torch
from torch import nn

from ..core import constants as C
from ..core.config import MambaBackboneConfig, RegressionConfig

from ..ops.attention import not_ported
from .bimamba import BiMambaEncoder


class VideoRegression(nn.Module):
    def __init__(self, cfg: RegressionConfig):
        super().__init__()
        if cfg.reg_model != "bimamba+":
            raise not_ported(f"the {cfg.reg_model!r} regression backbone",
                             "Queue 1, variant wirings")
        if cfg.use_kan:
            raise not_ported("KAN projections in the regression",
                             "Queue 1, variant wirings")
        self.cfg = cfg
        mcfg = MambaBackboneConfig(d_model=cfg.d_model, dropout=cfg.dropout,
                                   bias=True, use_version=1)
        self.in_proj = nn.Linear(cfg.total_vf_dim, cfg.d_model)
        self.backbone = BiMambaEncoder(mcfg, cfg.d_hidden, cfg.n_layers)
        self.regressor = nn.Linear(cfg.d_model, 2)
        self.classifier = nn.Linear(cfg.d_model, C.INSTRUMENT_SIZE)

    def forward(self, semantic, scene_offset, motion, emotion):
        """Live-path features are semantic + emotion only; returns
        (loudness/note density (B, L, 2), instrument probs (B, L, 40))."""
        del scene_offset, motion
        vf = torch.cat([semantic, emotion.to(semantic.dtype)], dim=-1)
        out = self.backbone(self.in_proj(vf))
        return self.regressor(out), torch.sigmoid(self.classifier(out))
