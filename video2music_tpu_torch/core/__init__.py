from . import constants
from .config import (
    AMTConfig,
    AttentionConfig,
    LayerSpec,
    MambaBackboneConfig,
    MoEConfig,
    MusicTransformerConfig,
    RegressionConfig,
    TrainConfig,
    amt_config,
)
from . import vocab

__all__ = [
    "constants",
    "vocab",
    "AMTConfig",
    "AttentionConfig",
    "LayerSpec",
    "MambaBackboneConfig",
    "MoEConfig",
    "MusicTransformerConfig",
    "RegressionConfig",
    "TrainConfig",
    "amt_config",
]
