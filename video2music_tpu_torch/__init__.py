"""video2music_tpu_torch — the PyTorch / CUDA port of video2music_tpu.

The JAX package ``video2music_tpu`` stays the reference; this package
mirrors its layout and module names. It imports ``torch`` and never
``jax``: of the JAX package it uses only the framework-free parts
(``core``, ``midi``, ``data.native``).

The slices ported so far are product inference from precomputed features
with AMT 2.2 and the bimamba+ regression: one clip
(``pipeline.api.Video2music.generate(features=...)``), a batch of clips
(``Video2music.generate_batch``) and dynamic batching
(``pipeline.serving.DynamicBatcher``). Their TPU kernels are hand-written
CUDA kernels under ``csrc/`` (see ``kernels.py``); each wrapper runs its
plain PyTorch version on CPU tensors and launches the kernel on CUDA
tensors.
"""

__version__ = "0.1.0"
