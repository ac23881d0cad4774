"""Models of the port: AMT 2.x (RoPE) and 3.x, and the bimamba+
regression."""

from .amt import VideoMusicTransformer
from .regression import VideoRegression

__all__ = ["VideoMusicTransformer", "VideoRegression"]
