"""Short-time Fourier transform and its inverse (``torch.stft`` / ``torch.istft`` semantics).

Same contract as ``audio_tpu.functional._stft``: center padding, framing by
hop, windowing, and a one-sided or full DFT, with the frequency axis before
the time axis in the output; the inverse by the inverse DFT, the window and
an overlap-add of the frames divided by that of the squared window.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["frame_signal", "stft", "istft", "num_frames"]

_PAD_MODES = {"reflect": "reflect", "constant": "constant", "replicate": "replicate", "circular": "circular"}


def _pad_center(waveform: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    if mode not in _PAD_MODES:
        raise ValueError(f"Unsupported pad_mode {mode!r}")
    lead = waveform.shape[:-1]
    flat = waveform.reshape(-1, 1, waveform.shape[-1])
    padded = F.pad(flat, (pad, pad), mode=_PAD_MODES[mode])
    return padded.reshape(lead + (padded.shape[-1],))


def num_frames(length: int, n_fft: int, hop_length: int, center: bool) -> int:
    if center:
        return 1 + length // hop_length
    return 1 + (length - n_fft) // hop_length


def frame_signal(waveform: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """Slice ``waveform`` (..., T) into overlapping frames (..., n_frames, frame_length)."""
    return waveform.unfold(-1, frame_length, hop_length)


def _prepare_window(window: Optional[torch.Tensor], n_fft: int, win_length: int, dtype,
                    device) -> torch.Tensor:
    if window is None:
        window = torch.ones((win_length,), dtype=dtype, device=device)
    if window.shape[-1] != win_length:
        raise ValueError(f"window length {window.shape[-1]} != win_length {win_length}")
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        window = F.pad(window, (left, n_fft - win_length - left))
    return window.to(dtype=dtype, device=device)


def stft(
    waveform: torch.Tensor,
    n_fft: int,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
    pad_mode: str = "reflect",
    normalized: bool = False,
    onesided: bool = True,
) -> torch.Tensor:
    """Complex STFT of shape (..., n_freq, n_frames); torch.stft semantics."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    window = _prepare_window(window, n_fft, win_length, waveform.dtype, waveform.device)
    if center:
        waveform = _pad_center(waveform, n_fft // 2, pad_mode)
    frames = frame_signal(waveform, n_fft, hop_length) * window  # (..., n_frames, n_fft)
    if onesided:
        spec = torch.fft.rfft(frames, dim=-1)
    else:
        spec = torch.fft.fft(frames, dim=-1)
    if normalized:
        spec = spec * (1.0 / math.sqrt(n_fft))
    return spec.transpose(-1, -2)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Sum frames (..., n_frames, n) placed ``hop_length`` apart: (..., n + hop (n_frames - 1))."""
    lead, (n_frames, n) = frames.shape[:-2], frames.shape[-2:]
    out_len = n + hop_length * (n_frames - 1)
    cols = frames.reshape(-1, n_frames, n).transpose(1, 2)  # (rows, n, n_frames)
    y = F.fold(cols, output_size=(1, out_len), kernel_size=(1, n), stride=(1, hop_length))
    return y.reshape(lead + (out_len,))


def _real_edge_bins(frames_f: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The DC bin, and the Nyquist bin of an even ``n_fft``, without their imaginary parts, which a one-sided
    inverse DFT reads as zero (numpy's and JAX's ``irfft``).  cuFFT's complex64 C2R transform of 4096 points reads the
    DC bin's imaginary part (``chip_smoke.py`` phase 18 prints what that changes)."""
    if not frames_f.is_complex():
        return frames_f
    keep = torch.ones(frames_f.shape[-1], dtype=frames_f.real.dtype, device=frames_f.device)
    keep[0] = 0
    if n_fft % 2 == 0 and n_fft // 2 < keep.shape[0]:
        keep[n_fft // 2] = 0
    return torch.complex(frames_f.real, frames_f.imag * keep)


def istft(
    spec: torch.Tensor,
    n_fft: int,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
    normalized: bool = False,
    onesided: bool = True,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT via windowed overlap-add; torch.istft semantics.

    ``spec`` is (..., n_freq, n_frames) complex; returns (..., T).
    """
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    real_dtype = spec.real.dtype if spec.is_complex() else spec.dtype
    window = _prepare_window(window, n_fft, win_length, real_dtype, spec.device)

    frames_f = spec.transpose(-1, -2)  # (..., n_frames, n_freq)
    if normalized:
        frames_f = frames_f * math.sqrt(n_fft)
    if onesided:
        frames = torch.fft.irfft(_real_edge_bins(frames_f, n_fft), n=n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(frames_f, dim=-1).real
    frames = frames * window  # (..., n_frames, n_fft)

    n_frames = frames.shape[-2]
    y = _overlap_add(frames, hop_length)
    norm = _overlap_add((window * window).expand(n_frames, n_fft), hop_length)
    out_len = y.shape[-1]

    if center:
        start = n_fft // 2
        end = out_len - n_fft // 2
    else:
        start, end = 0, out_len
    y = y[..., start:end]
    norm = norm[start:end]
    if length is not None:
        if y.shape[-1] < length:
            y = F.pad(y, (0, length - y.shape[-1]))
            norm = F.pad(norm, (0, length - norm.shape[-1]))
        else:
            y = y[..., :length]
            norm = norm[:length]
    norm = torch.where(norm > 1e-11, norm, 1.0)
    return y / norm
