"""Multi-layer (bi)directional GRU / LSTM stacks (counterpart of
models/rnn.py), on ``nn.GRU`` / ``nn.LSTM``.

The JAX package runs torch-parity cells under ``jax.lax.scan`` because the
reference used cuDNN's ``nn.GRU`` / ``nn.LSTM`` (reference:
model/video_regression.py:124-141); the port goes back to them: their
parameter names (``weight_ih_l0``, ``weight_hh_l0_reverse``, ...), gate
order and bidirectional concatenation are the JAX module's, and their
inter-layer dropout falls on every layer's output but the last, in
training only. No TPU kernel stands behind these backbones.
``ops/scan.py`` ``gru_scan`` / ``lstm_scan`` are the plain cell loops the
tests hold the stacks to.

cuDNN's RNN takes bfloat16 on an H100 80GB HBM3, but ran the full-width
regression forwards 6-26 ms there where float32 ran 0.7-2.6 ms
(chip_smoke.py "new backbones", ``PERF.md``). So the choice is fixed by
dtype: a bfloat16 stack runs its RNN in float32, on float32 copies of its
weights, and casts the output back.

The inter-layer dropout of a training call (a ``generator`` given) draws
from that generator: the stack then runs one layer at a time (each
through a one-layer RNN of the same kind, on the stack's weights) with the
dropout between them; otherwise it is one cuDNN call. The RNN module's
own dropout stays 0. A stack that trains must be in training mode (cuDNN
has no backward of an eval-mode forward), which a model is unless
``.eval()`` was called.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from ..ops.dropout import dropout


class RNNStack(nn.Module):
    """``cell`` "gru" | "lstm", hidden width ``d_model``; (B, L, I) ->
    (B, L, d_model), or (B, L, 2 d_model) when ``bidirectional``."""

    def __init__(self, cell: str, in_dim: int, d_model: int,
                 n_layers: int = 1, bidirectional: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        if cell not in ("gru", "lstm"):
            raise ValueError(f"unknown RNN cell {cell!r}")
        rnn = nn.GRU if cell == "gru" else nn.LSTM
        self.rnn = rnn(in_dim, d_model, n_layers, batch_first=True,
                       bidirectional=bidirectional)
        self.n_layers, self.dropout_rate = n_layers, dropout_rate
        self.out_dim = d_model * (2 if bidirectional else 1)
        # one-layer RNNs for a layer-by-layer training call (first layer,
        # later layers); a tuple, so not submodules: they run on the
        # stack's weights only
        self._one = tuple(rnn(width, d_model, 1, batch_first=True,
                              bidirectional=bidirectional)
                          for width in (in_dim, self.out_dim))

    def forward(self, x, generator=None):
        if (generator is not None and self.dropout_rate > 0.0
                and self.n_layers > 1):
            return self._layered(x, generator)
        if x.dtype != torch.float32:  # the float32 RNN (module docstring)
            weights = {n: p.float() for n, p in self.rnn.named_parameters()}
            return functional_call(self.rnn, weights,
                                   (x.float(),))[0].to(x.dtype)
        if x.is_cuda:  # cuDNN wants one weight buffer after a dtype cast
            self.rnn.flatten_parameters()
        return self.rnn(x)[0]

    def _layered(self, x, generator):
        """The stack one layer at a time, the dropout between layers."""
        weights = dict(self.rnn.named_parameters())
        h = x.float()
        for i in range(self.n_layers):
            one = self._one[min(i, 1)].train(self.training)
            w = {n: weights[n.replace("_l0", f"_l{i}")].float()
                 for n, _ in one.named_parameters()}
            h = functional_call(one, w, (h,))[0]
            if i < self.n_layers - 1:
                h = dropout(h, self.dropout_rate, generator)
        return h.to(x.dtype)
