"""Spectral ops: spectrogram and mel_spectrogram.

Same semantics as ``audio_tpu.functional._spectral``.  One-sided power and
magnitude spectrograms (power 2 or 1) go through one glue path,
``_power_spec_tm``, on every device: the configurations kernel K2 takes
(``spectrogram_supported``) into K2's wrapper (``ops/cuda_spectrogram.py``),
the kernel for a CUDA tensor and its plain version for a CPU tensor; every
other n_fft and hop into the plain version on the tensor's own device, as the
JAX package computes outside its kernel's gate.  Other powers, and complex
or two-sided spectrograms, take the STFT.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..ops.cuda_spectrogram import power_spectrogram, power_spectrogram_plain, spectrogram_supported
from ._stft import _pad_center, _prepare_window
from ._stft import stft as _stft

__all__ = ["spectrogram", "mel_spectrogram"]


def _get_spec_norms(normalized: Union[str, bool]):
    frame_length_norm, window_norm = False, False
    if isinstance(normalized, str):
        if normalized not in ("frame_length", "window"):
            raise ValueError(f"Invalid normalized parameter: {normalized}")
        frame_length_norm = normalized == "frame_length"
        window_norm = normalized == "window"
    elif isinstance(normalized, bool):
        window_norm = normalized
    else:
        raise TypeError("normalized must be bool or str")
    return frame_length_norm, window_norm


def _power_spec_tm(
    waveform: torch.Tensor,
    window: Optional[torch.Tensor],
    n_fft: int,
    hop_length: int,
    win_length: int,
    center: bool,
    pad_mode: str,
    power: float,
    fb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Time-major (..., time, bins) power (power 2), magnitude (power 1) or mel spectrogram.

    Inside K2's limits it runs through K2's wrapper: the kernel in float32 for
    a CUDA tensor, its plain version in the waveform's dtype for a CPU tensor.
    Outside them the plain version runs in the waveform's dtype on the
    waveform's device.
    """
    supported = spectrogram_supported(n_fft, hop_length, power)
    on_kernel = supported and waveform.is_cuda
    dtype = torch.float32 if on_kernel else waveform.dtype
    if on_kernel and fb is not None:
        fb = fb.float().contiguous()
    window = _prepare_window(window, n_fft, win_length, dtype, waveform.device)
    if center:
        waveform = _pad_center(waveform, n_fft // 2, pad_mode)
    lead = waveform.shape[:-1]
    x = waveform.reshape(-1, waveform.shape[-1]).to(dtype).contiguous()
    p = (power_spectrogram if supported else power_spectrogram_plain)(x, window, n_fft, hop_length, power, fb=fb)
    return p.reshape(lead + p.shape[1:])


def mel_spectrogram(
    waveform: torch.Tensor,
    fb: torch.Tensor,
    window: Optional[torch.Tensor] = None,
    n_fft: int = 400,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    center: bool = True,
    pad_mode: str = "reflect",
    power: float = 2.0,
    normalized: Union[bool, str] = False,
    time_major: bool = False,
) -> torch.Tensor:
    """Mel power spectrogram in one call.

    ``fb`` is the (n_freq, n_mels) filterbank from :func:`melscale_fbanks`.
    On CUDA the framing, windowed DFT, power and mel product run in kernel K2
    where it takes n_fft and hop, and in its plain version elsewhere.
    Returns (..., n_mels, time), or (..., time, n_mels) when ``time_major``.
    """
    hop_length = hop_length or n_fft // 2
    win_length = win_length or n_fft
    if power != 2.0:
        raise ValueError("mel fusion requires power=2.0")
    frame_length_norm, window_norm = _get_spec_norms(normalized)
    p = _power_spec_tm(waveform, window, n_fft, hop_length, win_length, center, pad_mode, 2.0, fb)
    if frame_length_norm:
        p = p / n_fft
    if window_norm:
        # sum in f32 whatever the waveform dtype, as the composed Spectrogram -> MelScale path
        w = _prepare_window(window, n_fft, win_length, waveform.dtype, waveform.device).float()
        p = p / torch.sum(w * w)
    if not time_major:
        p = p.transpose(-1, -2)
    # dtype follows the composed Spectrogram -> MelScale chain
    return p.to(torch.promote_types(waveform.dtype, fb.dtype))


def spectrogram(
    waveform: torch.Tensor,
    pad: int = 0,
    window: Optional[torch.Tensor] = None,
    n_fft: int = 400,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    power: Optional[float] = 2.0,
    normalized: Union[bool, str] = False,
    center: bool = True,
    pad_mode: str = "reflect",
    onesided: bool = True,
    return_complex: Optional[bool] = None,
) -> torch.Tensor:
    """Magnitude/power or complex spectrogram of shape (..., freq, time)."""
    if return_complex is not None:
        warnings.warn(
            "`return_complex` argument is now deprecated and is not effective."
            "`audio_tpu_torch.functional.spectrogram(power=None)` always returns a tensor with "
            "complex dtype. Please remove the argument in the function call."
        )
    hop_length = hop_length or n_fft // 2
    win_length = win_length or n_fft
    # reduced-precision inputs compute in f32; real outputs cast back
    in_dtype = waveform.dtype
    if in_dtype in (torch.bfloat16, torch.float16):
        out = spectrogram(
            waveform.float(), pad, None if window is None else window.float(), n_fft, hop_length,
            win_length, power, normalized, center, pad_mode, onesided,
        )
        return out.to(in_dtype) if power is not None else out
    if pad > 0:
        waveform = F.pad(waveform, (pad, pad))
    frame_length_norm, window_norm = _get_spec_norms(normalized)
    if power is not None and onesided and float(power) in (1.0, 2.0):
        power = float(power)
        spec = _power_spec_tm(waveform, window, n_fft, hop_length, win_length, center, pad_mode, power)
        if frame_length_norm:
            spec = spec * (float(n_fft) ** (-power / 2.0))
        spec = spec.transpose(-1, -2).to(waveform.dtype)
        if window_norm:
            w = window if window is not None else torch.ones((win_length,), dtype=waveform.dtype,
                                                               device=waveform.device)
            spec = spec / torch.sum(w * w) ** (power / 2.0)
        return spec
    spec_f = _stft(
        waveform,
        n_fft=n_fft,
        hop_length=hop_length,
        win_length=win_length,
        window=window,
        center=center,
        pad_mode=pad_mode,
        normalized=frame_length_norm,
        onesided=onesided,
    )
    if window_norm:
        w = window if window is not None else torch.ones((win_length,), dtype=waveform.dtype, device=waveform.device)
        spec_f = spec_f / torch.sqrt(torch.sum(w * w))
    if power is not None:
        if power == 1.0:
            return torch.abs(spec_f)
        return torch.abs(spec_f) ** power
    return spec_f
