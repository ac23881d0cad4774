"""Dynamic request batching for the port (counterpart of
pipeline/serving.py).

The JAX package's ``serving.py`` imports only the standard library and
drives any object with ``generate_batch`` / ``extract_features_batch``, but
its package ``__init__`` imports JAX. So the very same file is loaded here
by path, without its package, and its classes are re-exported: the
batching policy (gather window, power-of-two buckets with pad clones,
priorities, deadlines, load shedding, the render thread, controls) cannot
drift from the JAX package's.

    batcher = DynamicBatcher(Video2music(), max_batch=16)
    result, width = batcher.submit({"features": feats}, 0.9).result()
"""

from __future__ import annotations

import importlib.util
import os
import sys

import video2music_tpu

_NAME = __name__ + "._policy"
_PATH = os.path.join(os.path.dirname(video2music_tpu.__file__), "pipeline",
                     "serving.py")


def _load():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    spec = importlib.util.spec_from_file_location(_NAME, _PATH)
    module = importlib.util.module_from_spec(spec)
    sys.modules[_NAME] = module  # dataclasses resolve their module here
    spec.loader.exec_module(module)
    return module


_policy = _load()
DynamicBatcher = _policy.DynamicBatcher
Overloaded = _policy.Overloaded
DeadlineExceeded = _policy.DeadlineExceeded
DEFAULT_BUCKETS = _policy.DEFAULT_BUCKETS

__all__ = ["DynamicBatcher", "Overloaded", "DeadlineExceeded",
           "DEFAULT_BUCKETS"]
