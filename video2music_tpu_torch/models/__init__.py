"""Models of the port: AMT 2.2 and the bimamba+ regression."""

from .amt import VideoMusicTransformer
from .regression import VideoRegression

__all__ = ["VideoMusicTransformer", "VideoRegression"]
