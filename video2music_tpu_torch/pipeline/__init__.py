"""The product API of the port."""

from .api import GenerateResult, Video2music
from .primer import parse_primer, resolve_key_and_primer

__all__ = ["Video2music", "GenerateResult", "parse_primer",
           "resolve_key_and_primer"]
