"""Models of the port: every AMT wiring of ``amt_config``, the fourteen
regression backbones, and the no-video MusicTransformer baseline."""

from .amt import VideoMusicTransformer
from .music_transformer import MusicTransformer
from .regression import VideoRegression

__all__ = ["MusicTransformer", "VideoMusicTransformer", "VideoRegression"]
