"""Spectral ops: spectrogram, its inverse, Griffin-Lim, decibels, phase vocoder, centroid.

Same semantics as ``audio_tpu.functional._spectral``.  One-sided power and
magnitude spectrograms (power 2 or 1) go through one glue path,
``_power_spec_tm``, on every device: the configurations kernel K2 takes
(``spectrogram_supported``) into K2's wrapper (``ops/cuda_spectrogram.py``),
the kernel for a CUDA tensor and its plain version for a CPU tensor; every
other n_fft and hop into the plain version on the tensor's own device, as the
JAX package computes outside its kernel's gate.  Other powers, and complex
or two-sided spectrograms, take the STFT.  The inverse spectrogram and
Griffin-Lim run the inverse STFT (``_stft.istft``: the library's inverse FFT
and an overlap-add, as the JAX package computes them outside any kernel);
``spectral_centroid`` reads a magnitude spectrogram, so on CUDA it runs
kernel K2 where K2 takes n_fft and hop.  Randomness comes from a
``torch.Generator`` where the JAX package takes a key.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda_spectrogram import power_spectrogram, power_spectrogram_plain, spectrogram_supported
from ._stft import _pad_center, _prepare_window
from ._stft import istft as _istft
from ._stft import stft as _stft

__all__ = [
    "spectrogram",
    "inverse_spectrogram",
    "griffinlim",
    "amplitude_to_DB",
    "DB_to_amplitude",
    "mel_spectrogram",
    "phase_vocoder",
    "spectral_centroid",
]


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


def inverse_spectrogram(
    spectrogram: torch.Tensor,
    length: Optional[int],
    pad: int = 0,
    window: Optional[torch.Tensor] = None,
    n_fft: int = 400,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    normalized: Union[bool, str] = False,
    center: bool = True,
    pad_mode: str = "reflect",
    onesided: bool = True,
) -> torch.Tensor:
    """Least-squares inverse of a complex spectrogram; returns (..., time)."""
    hop_length = hop_length or n_fft // 2
    win_length = win_length or n_fft
    if not spectrogram.is_complex():
        raise ValueError("Expected `spectrogram` to be complex dtype.")
    frame_length_norm, window_norm = _get_spec_norms(normalized)
    if window_norm:
        w = window if window is not None else torch.ones((win_length,), dtype=spectrogram.real.dtype,
                                                         device=spectrogram.device)
        spectrogram = spectrogram * torch.sqrt(torch.sum(w * w))
    waveform = _istft(
        spectrogram,
        n_fft=n_fft,
        hop_length=hop_length,
        win_length=win_length,
        window=window,
        center=center,
        normalized=frame_length_norm,
        onesided=onesided,
        length=length + 2 * pad if length is not None else None,
    )
    if length is not None and pad > 0:
        waveform = waveform[..., pad:-pad]
    return waveform


def griffinlim(
    specgram: torch.Tensor,
    window: Optional[torch.Tensor] = None,
    n_fft: int = 400,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    power: float = 2.0,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: Optional[int] = None,
    rand_init: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Griffin-Lim phase recovery (fast variant with momentum).

    Half-precision inputs compute in f32 and cast back on return.  With
    ``rand_init`` the initial phases' real and imaginary parts are drawn
    uniformly from ``generator``, on its device (``None``: a generator on the
    spectrogram's device seeded 0).  The ``n_iter`` iterations of inverse STFT
    then STFT read nothing back from the device.
    """
    if not 0 <= momentum < 1:
        raise ValueError(f"momentum must be in range [0, 1). Found: {momentum}")
    if specgram.dtype in (torch.bfloat16, torch.float16):
        out = griffinlim(
            specgram.float(), window=None if window is None else window.float(), n_fft=n_fft,
            hop_length=hop_length, win_length=win_length, power=power, n_iter=n_iter, momentum=momentum,
            length=length, rand_init=rand_init, generator=generator,
        )
        return out.to(specgram.dtype)
    hop_length = hop_length or n_fft // 2
    win_length = win_length or n_fft
    momentum = momentum / (1 + momentum)

    mag = specgram ** (1 / power)
    cdtype = torch.complex128 if mag.dtype == torch.float64 else torch.complex64
    if rand_init:
        if generator is None:
            generator = torch.Generator(device=mag.device).manual_seed(0)
        re, im = (torch.rand(mag.shape, generator=generator, dtype=mag.dtype, device=generator.device)
                  for _ in range(2))
        angles = torch.complex(re, im).to(device=mag.device, dtype=cdtype)
    else:
        angles = torch.ones(mag.shape, dtype=cdtype, device=mag.device)

    tprev = torch.zeros_like(angles)
    for _ in range(n_iter):
        inverse = _istft(
            mag * angles, n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window, length=length
        )
        rebuilt = _stft(
            inverse, n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window,
            center=True, pad_mode="reflect", normalized=False, onesided=True,
        )
        angles = rebuilt - tprev * momentum if momentum else rebuilt
        angles = angles / (torch.abs(angles) + 1e-16)
        tprev = rebuilt
    return _istft(
        mag * angles, n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window, length=length
    )


def amplitude_to_DB(
    x: torch.Tensor,
    multiplier: float,
    amin: float,
    db_multiplier: float,
    top_db: Optional[float] = None,
) -> torch.Tensor:
    """Power/amplitude -> decibel scale with an optional per-clip ``top_db`` floor, taken over the
    last three axes (channels, freq, time)."""
    x_db = multiplier * torch.log10(torch.clamp(x, min=amin))
    x_db = x_db - multiplier * db_multiplier
    if top_db is not None:
        shape = x_db.shape
        packed_channels = shape[-3] if x_db.dim() > 2 else 1
        x_db = x_db.reshape((-1, packed_channels) + tuple(shape[-2:]))
        cutoff = torch.amax(x_db, dim=(-3, -2, -1), keepdim=True) - top_db
        x_db = torch.maximum(x_db, cutoff)
        x_db = x_db.reshape(shape)
    return x_db


def DB_to_amplitude(x: torch.Tensor, ref: float, power: float) -> torch.Tensor:
    return ref * torch.pow(torch.pow(10.0, 0.1 * x), power)


_NUMPY_REAL = {torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}


def phase_vocoder(complex_specgrams: torch.Tensor, rate: float, phase_advance: torch.Tensor) -> torch.Tensor:
    """Time-stretch a complex spectrogram by ``rate`` without changing pitch.

    ``phase_advance`` is (freq, 1) expected phase advance per hop.  Output has
    ``ceil(time / rate)`` frames.  The time steps are numpy's ``arange``, as
    the JAX package's, made on the host.
    """
    if rate == 1.0:
        return complex_specgrams
    real_dtype = complex_specgrams.real.dtype
    steps = np.arange(0, complex_specgrams.shape[-1], rate, dtype=_NUMPY_REAL[real_dtype])
    time_steps = torch.from_numpy(steps).to(complex_specgrams.device)
    alphas = time_steps % 1.0
    phase_0 = torch.angle(complex_specgrams[..., :1])
    padded = F.pad(complex_specgrams, (0, 2))
    idx = torch.from_numpy(steps.astype(np.int64)).to(complex_specgrams.device)
    spec_0 = padded[..., idx]
    spec_1 = padded[..., idx + 1]
    angle_0 = torch.angle(spec_0)
    angle_1 = torch.angle(spec_1)
    norm_0 = torch.abs(spec_0)
    norm_1 = torch.abs(spec_1)
    phase = angle_1 - angle_0 - phase_advance
    phase = phase - 2 * math.pi * torch.round(phase / (2 * math.pi))
    phase = phase + phase_advance
    phase = torch.cat([phase_0, phase[..., :-1]], dim=-1)
    phase_acc = torch.cumsum(phase, dim=-1)
    mag = alphas * norm_1 + (1 - alphas) * norm_0
    return mag * torch.exp(1j * phase_acc)


def spectral_centroid(
    waveform: torch.Tensor,
    sample_rate: int,
    pad: int = 0,
    window: Optional[torch.Tensor] = None,
    n_fft: int = 400,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
) -> torch.Tensor:
    """Spectral centroid in Hz per frame: (..., time).

    The frequency-weighted magnitude sum reaches Hz x frames scale, which
    overflows float16's 65504 max, so the reduction accumulates in at least
    f32 and the result is cast back to the input dtype.  The magnitude
    spectrogram runs kernel K2 on CUDA where K2 takes n_fft and hop.
    """
    hop_length = hop_length or n_fft // 2
    win_length = win_length or n_fft
    specgram = spectrogram(
        waveform, pad=pad, window=window, n_fft=n_fft, hop_length=hop_length,
        win_length=win_length, power=1.0, normalized=False,
    )
    acc = torch.promote_types(specgram.dtype, torch.float32)
    freqs = torch.linspace(0, sample_rate // 2, 1 + n_fft // 2, dtype=acc, device=specgram.device)
    sg = specgram.to(acc)
    out = torch.sum(freqs[..., None] * sg, dim=-2) / torch.sum(sg, dim=-2)
    return out.to(specgram.dtype)
