"""Transforms of the PyTorch port: ``MelSpectrogram``, which the RNN-T pipeline uses."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .. import functional as F
from .._internal.windows import hann_window

__all__ = ["MelSpectrogram"]


class MelSpectrogram(nn.Module):
    """Mel power spectrogram of a waveform (..., time) -> (..., n_mels, frames).

    The same parameters and layout as ``audio_tpu.transforms.MelSpectrogram``.
    Framing, windowed DFT, power and the mel product run in one call of
    ``functional.mel_spectrogram`` at ``power=2.0``: kernel K2 for a CUDA
    waveform where it takes n_fft and hop.  Any other power composes
    ``functional.spectrogram`` with the mel product, as the JAX class does.
    Window and filterbank are buffers, made on ``device`` (CUDA unless the
    caller says otherwise).
    """

    def __init__(
        self,
        sample_rate: int = 16000,
        n_fft: int = 400,
        win_length: Optional[int] = None,
        hop_length: Optional[int] = None,
        f_min: float = 0.0,
        f_max: Optional[float] = None,
        pad: int = 0,
        n_mels: int = 128,
        window_fn: Callable = hann_window,
        power: float = 2.0,
        normalized: bool = False,
        wkwargs: Optional[dict] = None,
        center: bool = True,
        pad_mode: str = "reflect",
        norm: Optional[str] = None,
        mel_scale: str = "htk",
        device="cuda",
    ) -> None:
        super().__init__()
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.win_length = win_length if win_length is not None else n_fft
        self.hop_length = hop_length if hop_length is not None else self.win_length // 2
        self.pad = pad
        self.power = power
        self.normalized = normalized
        self.n_mels = n_mels
        self.f_min = f_min
        self.f_max = f_max if f_max is not None else float(sample_rate // 2)
        if f_min > self.f_max:
            raise ValueError(f"Require f_min: {f_min} <= f_max: {self.f_max}")
        self.center = center
        self.pad_mode = pad_mode
        self.register_buffer("window", window_fn(self.win_length, device=device, **(wkwargs or {})),
                             persistent=False)
        self.register_buffer(
            "fb", F.melscale_fbanks(n_fft // 2 + 1, self.f_min, self.f_max, n_mels, sample_rate, norm, mel_scale,
                                    device=device),
            persistent=False)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        if self.power != 2.0:
            spec = F.spectrogram(waveform, pad=self.pad, window=self.window, n_fft=self.n_fft,
                                 hop_length=self.hop_length, win_length=self.win_length, power=self.power,
                                 normalized=self.normalized, center=self.center, pad_mode=self.pad_mode)
            return (spec.transpose(-1, -2) @ self.fb.to(spec.dtype)).transpose(-1, -2)
        if self.pad > 0:
            waveform = torch.nn.functional.pad(waveform, (self.pad, self.pad))
        return F.mel_spectrogram(
            waveform, fb=self.fb.to(waveform.dtype), window=self.window, n_fft=self.n_fft,
            hop_length=self.hop_length, win_length=self.win_length, center=self.center, pad_mode=self.pad_mode,
            power=2.0, normalized=self.normalized)
