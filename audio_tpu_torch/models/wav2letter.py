"""Wav2Letter: (B, num_features, T) -> log-probabilities (B, num_classes, T').

Same architecture as ``audio_tpu.models.wav2letter`` with torchaudio's module tree, so a ``state_dict`` passes
to and from the JAX package's ``import_wav2letter_state_dict``: the acoustic stack ``acoustic_model.{0,2,...,20}``
(11 convolutions, each followed by a ReLU, the last one too) and, for waveform input, a front convolution of
kernel 250 and stride 160 before it (``acoustic_model.0.0``, the stack then under ``acoustic_model.1``).  The
output is ``log_softmax`` over the classes.  Every convolution runs with cuDNN's TF32 off in its forward and its
backward (``utils.precision.exact_conv_module``).  The parameters are made on CUDA unless the caller names another
device, and drawn from ``generator`` (torch's default ranges) when one is given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import exact_conv_module
from .conformer import _reset_conv

__all__ = ["Wav2Letter"]

# (out channels, kernel, stride, padding) of the acoustic stack after its first convolution's input
_STACK = [(250, 48, 2, 23)] + [(250, 7, 1, 3)] * 7 + [(2000, 32, 1, 16), (2000, 1, 1, 0)]


def _relu_convs(in_channels: int, layers, kw: dict) -> nn.Sequential:
    modules = []
    for out_channels, kernel, stride, padding in layers:
        modules += [nn.Conv1d(in_channels, out_channels, kernel, stride=stride, padding=padding, **kw), nn.ReLU()]
        in_channels = out_channels
    return nn.Sequential(*modules)


class Wav2Letter(nn.Module):
    """Wav2Letter of torchaudio: ``input_type`` "waveform" (``num_features`` channels of samples), "power_spectrum"
    or "mfcc" (``num_features`` bins a frame)."""

    def __init__(self, num_classes: int = 40, input_type: str = "waveform", num_features: int = 1, device="cuda",
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if input_type not in ("waveform", "power_spectrum", "mfcc"):
            raise ValueError(f"Unsupported input_type {input_type}")
        kw = dict(device=device, dtype=dtype)
        acoustic_features = 250 if input_type == "waveform" else num_features
        acoustic = _relu_convs(acoustic_features, _STACK + [(num_classes, 1, 1, 0)], kw)
        if input_type == "waveform":
            front = _relu_convs(num_features, [(250, 250, 160, 45)], kw)
            self.acoustic_model = nn.Sequential(front, acoustic)
        else:
            self.acoustic_model = acoustic
        for module in self.modules():
            if isinstance(module, nn.Conv1d):
                _reset_conv(module, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, num_features, T) -> log-probabilities (B, num_classes, T')."""
        for module in self.modules():
            if isinstance(module, nn.Conv1d):
                x = F.relu(exact_conv_module(module, x))
        return F.log_softmax(x, dim=1)
