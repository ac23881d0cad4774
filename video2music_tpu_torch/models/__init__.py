"""Models of the port: every AMT wiring of ``amt_config`` and the
Mamba-family regressions."""

from .amt import VideoMusicTransformer
from .regression import VideoRegression

__all__ = ["VideoMusicTransformer", "VideoRegression"]
