"""video2music_tpu_torch — the PyTorch / CUDA port of video2music_tpu.

The JAX package ``video2music_tpu`` stays the reference; this package
mirrors its layout and module names. It imports ``torch`` and nothing of
the JAX package: the framework-free modules it needs (``core``, ``midi``,
``data.native``, ``data.parsers``, ``data.dataset``,
``pipeline/serving.py``) are its own copies.

The slices ported so far are product inference from precomputed features
with every AMT wiring and the Mamba-family regressions: one clip
(``pipeline.api.Video2music.generate(features=...)``), a batch of clips
(``Video2music.generate_batch``) and dynamic batching
(``pipeline.serving.DynamicBatcher``); and AMT 2.2 training
(``train.loop.train_amt``, ``train.step.make_amt_train_step``). Their TPU
kernels are hand-written CUDA kernels under ``csrc/`` (see
``kernels.py``); each wrapper runs its plain PyTorch version on CPU
tensors and launches the kernel on CUDA tensors.
"""

__version__ = "0.1.0"
