"""video2music_tpu_torch — the PyTorch / CUDA port of video2music_tpu.

The JAX package ``video2music_tpu`` stays the reference; this package
mirrors its layout and module names. It imports ``torch`` and nothing of
the JAX package: the framework-free modules it needs (``core``, ``midi``,
``data.native``, ``data.parsers``, ``data.dataset``,
``pipeline/serving.py``) are its own copies.

The slices ported so far are product inference from a video or from
precomputed features with every AMT wiring and every regression backbone:
one clip (``pipeline.api.Video2music.generate``), a batch of clips
(``Video2music.generate_batch``) and dynamic batching
(``pipeline.serving.DynamicBatcher``); training of every model it serves
(``train.loop``); the JAX package's command line (``cli``: ``python -m
video2music_tpu_torch.cli.<name>``) and observability (``obs``: the MoE
expert-emotion counts, TensorBoard scalars; the step profiler in
``train.loop``). Multi-GPU training is not ported. Their TPU
kernels are hand-written CUDA kernels under ``csrc/`` (see
``kernels.py``); each wrapper runs its plain PyTorch version on CPU
tensors and launches the kernel on CUDA tensors.
"""

__version__ = "0.1.0"
