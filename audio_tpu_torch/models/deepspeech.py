"""DeepSpeech: (B, 1, T, n_feature) -> log-probabilities (B, T, n_class).

Same architecture as ``audio_tpu.models.deepspeech`` with torchaudio's module tree, so a ``state_dict`` passes
to and from the JAX package's ``import_deepspeech_state_dict``: three fully connected layers ``fc1``-``fc3``
(each a ReLU clipped at 20), one bidirectional ReLU ``nn.RNN`` (``bi_rnn``) whose two directions are summed, a
fourth clipped layer ``fc4``, the output layer ``out`` and ``log_softmax`` over the classes.  The recurrence is
cuDNN's RNN on the card, which reads cuDNN's TF32 flag: it runs with TF32 off in its forward and its backward
(``utils.precision.tf32_off``).  The parameters are made on CUDA unless the caller names another device, and
drawn from ``generator`` (torch's default ranges) when one is given.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import tf32_off
from .emformer import _reset_linear, _uniform_

__all__ = ["DeepSpeech"]


class FullyConnected(nn.Module):
    """Linear -> ReLU clipped at ``relu_max_clip`` -> dropout."""

    def __init__(self, n_feature: int, n_hidden: int, dropout: float, relu_max_clip: int = 20, device="cuda",
                 dtype=None):
        super().__init__()
        self.fc = nn.Linear(n_feature, n_hidden, device=device, dtype=dtype)
        self.relu_max_clip = relu_max_clip
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.clamp(F.relu(self.fc(x)), 0, self.relu_max_clip)
        if self.dropout:
            x = F.dropout(x, self.dropout, self.training)
        return x


class DeepSpeech(nn.Module):
    """DeepSpeech of torchaudio (n_hidden 2048 by default)."""

    def __init__(self, n_feature: int, n_hidden: int = 2048, n_class: int = 40, dropout: float = 0.0,
                 device="cuda", dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.n_hidden = n_hidden
        self.fc1 = FullyConnected(n_feature, n_hidden, dropout, **kw)
        self.fc2 = FullyConnected(n_hidden, n_hidden, dropout, **kw)
        self.fc3 = FullyConnected(n_hidden, n_hidden, dropout, **kw)
        self.bi_rnn = nn.RNN(n_hidden, n_hidden, num_layers=1, nonlinearity="relu", bidirectional=True, **kw)
        self.fc4 = FullyConnected(n_hidden, n_hidden, dropout, **kw)
        self.out = nn.Linear(n_hidden, n_class, **kw)
        if generator is not None:
            for fc in (self.fc1, self.fc2, self.fc3):
                _reset_linear(fc.fc, generator)
            for p in self.bi_rnn.parameters():  # nn.RNN's own range, U(+-1 / sqrt(hidden))
                _uniform_(p, 1.0 / math.sqrt(n_hidden), generator)
            _reset_linear(self.fc4.fc, generator)
            _reset_linear(self.out, generator)

    def _recurrence(self, x: torch.Tensor) -> torch.Tensor:
        """(T, B, H) -> (T, B, 2H) of the bidirectional RNN with TF32 off in both directions."""
        names = [name for name, _ in self.bi_rnn.named_parameters()]

        def run(x_, *weights):
            return torch.func.functional_call(self.bi_rnn, dict(zip(names, weights)), (x_,))[0]

        return tf32_off(run, x, *self.bi_rnn.parameters())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 1, T, n_feature) -> log-probabilities (B, T, n_class)."""
        x = self.fc3(self.fc2(self.fc1(x)))
        x = self._recurrence(x.squeeze(1).transpose(0, 1))  # (T, B, 2H)
        x = x[:, :, : self.n_hidden] + x[:, :, self.n_hidden:]
        x = self.out(self.fc4(x))
        return F.log_softmax(x.permute(1, 0, 2), dim=2)
