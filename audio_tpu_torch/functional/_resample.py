"""Bandlimited sinc resampling (polyphase), on the waveform's device.

Same contract as ``audio_tpu.functional._resample``: the polyphase sinc
kernel is built on the host in numpy float64 (hann or kaiser window, rolloff
anti-aliasing), then cast to the waveform's dtype and moved to its device.
On the CPU the kernel is applied as the JAX package applies it there: a
frame view of the padded signal times the kernel.  On CUDA that frame
gather would grow the signal by kernel width / ``orig_freq`` (about 14x at
48 kHz -> 16 kHz), so the strided product runs as one strided convolution,
the JAX package's form on the TPU, with TF32 off in its forward and its
backward whatever the caller's cuDNN flags (``utils.precision.exact_conv``):
the DSP products are exact float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import exact_conv
from ._stft import frame_signal

__all__ = ["resample", "get_sinc_resample_kernel", "apply_sinc_resample_kernel"]


def get_sinc_resample_kernel(
    orig_freq: int,
    new_freq: int,
    gcd: Optional[int] = None,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
    resampling_method: str = "sinc_interp_hann",
    beta: Optional[float] = None,
    dtype=torch.float32,
) -> Tuple[torch.Tensor, int]:
    """Build the polyphase kernel; returns ((new_freq, kernel_width), width).

    Constructed in float64 on the host, then cast to ``dtype`` (a CPU tensor;
    ``apply_sinc_resample_kernel`` moves it to the waveform's device).
    """
    if not (int(orig_freq) == orig_freq and int(new_freq) == new_freq):
        raise ValueError("Frequencies must be of integer type to ensure quality resampling computation.")
    if resampling_method not in ("sinc_interp_hann", "sinc_interp_kaiser"):
        raise ValueError(f"Invalid resampling method: {resampling_method}")
    if gcd is None:
        gcd = math.gcd(int(orig_freq), int(new_freq))
    orig_freq = int(orig_freq) // gcd
    new_freq = int(new_freq) // gcd
    if lowpass_filter_width <= 0:
        raise ValueError("Low pass filter width should be positive.")

    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)

    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)

    if resampling_method == "sinc_interp_hann":
        window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    else:
        if beta is None:
            beta = 14.769656459379492
        window = np.i0(beta * np.sqrt(np.maximum(0.0, 1 - (t / lowpass_filter_width) ** 2))) / np.i0(beta)

    t = t * math.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = kernels * window * scale
    return torch.as_tensor(kernels, dtype=dtype), width


def apply_sinc_resample_kernel(
    waveform: torch.Tensor,
    orig_freq: int,
    new_freq: int,
    gcd: int,
    kernel: torch.Tensor,
    width: int,
) -> torch.Tensor:
    if not waveform.is_floating_point():
        raise TypeError(f"Expected floating point type for waveform tensor, but received {waveform.dtype}.")
    orig_freq = int(orig_freq) // gcd
    new_freq = int(new_freq) // gcd

    shape = waveform.shape
    length = shape[-1]
    x = F.pad(waveform.reshape(-1, length), (width, width + orig_freq))
    kernel = kernel.to(device=x.device, dtype=x.dtype)
    if x.is_cuda:
        y = exact_conv(x[:, None, :], kernel[:, None, :], stride=orig_freq)  # (B, new_freq, n_frames)
        resampled = y.transpose(1, 2).reshape(x.shape[0], -1)
    else:
        frames = frame_signal(x, kernel.shape[-1], orig_freq)  # (B, n_frames, K)
        resampled = torch.einsum("bnk,fk->bnf", frames, kernel).reshape(x.shape[0], -1)
    target_length = int(math.ceil(new_freq * length / orig_freq))
    resampled = resampled[..., :target_length]
    return resampled.reshape(shape[:-1] + (target_length,))


def resample(
    waveform: torch.Tensor,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
    resampling_method: str = "sinc_interp_hann",
    beta: Optional[float] = None,
) -> torch.Tensor:
    """Resample (..., time) from orig_freq to new_freq by bandlimited interpolation."""
    if orig_freq <= 0.0 or new_freq <= 0.0:
        raise ValueError("Original frequency and desired frequency should be positive")
    if orig_freq == new_freq:
        return waveform
    gcd = math.gcd(int(orig_freq), int(new_freq))
    kernel, width = get_sinc_resample_kernel(
        orig_freq, new_freq, gcd, lowpass_filter_width, rolloff, resampling_method, beta, dtype=waveform.dtype
    )
    return apply_sinc_resample_kernel(waveform, orig_freq, new_freq, gcd, kernel, width)
