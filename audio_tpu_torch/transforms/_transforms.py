"""Transforms of the PyTorch port: modules that hold their precomputed buffers.

The same classes, parameters and defaults as ``audio_tpu.transforms``.  Each
class is an ``nn.Module``; its windows, filterbanks, DCT matrices, resampling
kernels, ``phase_advance`` and ``fb_pinv`` are non-persistent buffers made on
``device`` (CUDA unless the caller names another), and ``forward`` casts them
to its input's dtype.  Classes without buffers follow their input's device.
Each wraps a function of ``audio_tpu_torch.functional``, so on the card it
reaches the kernels those functions reach: ``Spectrogram`` at power 1 or 2,
``MelSpectrogram``, ``MFCC``, ``LFCC`` and ``SpectralCentroid`` kernel K2,
``Deemphasis`` and ``Loudness`` kernel K1, ``RNNTLoss`` kernel K8.  The
filterbank and DCT products are exact float32 (``utils.precision.exact_matmul``).
Random transforms take a ``torch.Generator`` where the JAX package takes a key;
``None`` means a generator seeded 0 on the input's device.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .. import functional as F
from .._internal.windows import hann_window
from ..functional._misc import _speed_lengths, _speed_rates
from ..functional._resample import apply_sinc_resample_kernel, get_sinc_resample_kernel
from ..utils.precision import exact_matmul

__all__ = [
    "Spectrogram",
    "InverseSpectrogram",
    "GriffinLim",
    "AmplitudeToDB",
    "MelScale",
    "InverseMelScale",
    "MelSpectrogram",
    "MFCC",
    "LFCC",
    "MuLawEncoding",
    "MuLawDecoding",
    "Resample",
    "ComputeDeltas",
    "TimeStretch",
    "Fade",
    "FrequencyMasking",
    "TimeMasking",
    "SpecAugment",
    "Loudness",
    "Vol",
    "SlidingWindowCmn",
    "SpectralCentroid",
    "PitchShift",
    "RNNTLoss",
    "Convolve",
    "FFTConvolve",
    "Speed",
    "SpeedPerturbation",
    "AddNoise",
    "Preemphasis",
    "Deemphasis",
    "Vad",
]


def _bank(specgram: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """(..., n, time) through the (n, k) ``bank`` -> (..., k, time), in the spectrogram's dtype."""
    return exact_matmul(specgram.transpose(-1, -2), bank.to(specgram.dtype)).transpose(-1, -2)


def _default_generator(generator: Optional[torch.Generator], device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0) if generator is None else generator


class Spectrogram(nn.Module):
    """Power, magnitude or complex spectrogram (..., time) -> (..., freq, frames)."""

    def __init__(
        self,
        n_fft: int = 400,
        win_length: Optional[int] = None,
        hop_length: Optional[int] = None,
        pad: int = 0,
        window_fn: Callable = hann_window,
        power: Optional[float] = 2.0,
        normalized: Union[bool, str] = False,
        wkwargs: Optional[dict] = None,
        center: bool = True,
        pad_mode: str = "reflect",
        onesided: bool = True,
        return_complex: Optional[bool] = None,
        device="cuda",
    ) -> None:
        super().__init__()
        if return_complex is not None:
            warnings.warn(
                "`return_complex` argument is now deprecated and is not effective."
                "`power=None` always returns a tensor with complex dtype."
            )
        self.n_fft = n_fft
        self.win_length = win_length if win_length is not None else n_fft
        self.hop_length = hop_length if hop_length is not None else self.win_length // 2
        self.pad = pad
        self.power = power
        self.normalized = normalized
        self.center = center
        self.pad_mode = pad_mode
        self.onesided = onesided
        self.register_buffer("window", window_fn(self.win_length, device=device, **(wkwargs or {})),
                             persistent=False)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return F.spectrogram(
            waveform, pad=self.pad, window=self.window, n_fft=self.n_fft, hop_length=self.hop_length,
            win_length=self.win_length, power=self.power, normalized=self.normalized, center=self.center,
            pad_mode=self.pad_mode, onesided=self.onesided,
        )


class InverseSpectrogram(nn.Module):
    """Complex spectrogram (..., freq, frames) -> waveform (..., time)."""

    def __init__(
        self,
        n_fft: int = 400,
        win_length: Optional[int] = None,
        hop_length: Optional[int] = None,
        pad: int = 0,
        window_fn: Callable = hann_window,
        normalized: Union[bool, str] = False,
        wkwargs: Optional[dict] = None,
        center: bool = True,
        pad_mode: str = "reflect",
        onesided: bool = True,
        device="cuda",
    ) -> None:
        super().__init__()
        self.n_fft = n_fft
        self.win_length = win_length if win_length is not None else n_fft
        self.hop_length = hop_length if hop_length is not None else self.win_length // 2
        self.pad = pad
        self.normalized = normalized
        self.center = center
        self.pad_mode = pad_mode
        self.onesided = onesided
        self.register_buffer("window", window_fn(self.win_length, device=device, **(wkwargs or {})),
                             persistent=False)

    def forward(self, spectrogram: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        return F.inverse_spectrogram(
            spectrogram, length=length, pad=self.pad, window=self.window, n_fft=self.n_fft,
            hop_length=self.hop_length, win_length=self.win_length, normalized=self.normalized,
            center=self.center, pad_mode=self.pad_mode, onesided=self.onesided,
        )


class GriffinLim(nn.Module):
    """Waveform from a magnitude or power spectrogram by Griffin-Lim phase recovery."""

    def __init__(
        self,
        n_fft: int = 400,
        n_iter: int = 32,
        win_length: Optional[int] = None,
        hop_length: Optional[int] = None,
        window_fn: Callable = hann_window,
        power: float = 2.0,
        wkwargs: Optional[dict] = None,
        momentum: float = 0.99,
        length: Optional[int] = None,
        rand_init: bool = True,
        device="cuda",
    ) -> None:
        super().__init__()
        self.n_fft = n_fft
        self.n_iter = n_iter
        self.win_length = win_length if win_length is not None else n_fft
        self.hop_length = hop_length if hop_length is not None else self.win_length // 2
        self.register_buffer("window", window_fn(self.win_length, device=device, **(wkwargs or {})),
                             persistent=False)
        self.power = power
        self.momentum = momentum
        self.length = length
        self.rand_init = rand_init

    def forward(self, specgram: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return F.griffinlim(
            specgram, window=self.window, n_fft=self.n_fft, hop_length=self.hop_length,
            win_length=self.win_length, power=self.power, n_iter=self.n_iter, momentum=self.momentum,
            length=self.length, rand_init=self.rand_init, generator=generator,
        )


class AmplitudeToDB(nn.Module):
    """Power or amplitude to decibels, with an optional ``top_db`` floor per clip."""

    def __init__(self, stype: str = "power", top_db: Optional[float] = None) -> None:
        super().__init__()
        self.stype = stype
        if top_db is not None and top_db < 0:
            raise ValueError("top_db must be positive value")
        self.top_db = top_db
        self.multiplier = 10.0 if stype == "power" else 20.0
        self.amin = 1e-10
        self.ref_value = 1.0
        self.db_multiplier = math.log10(max(self.amin, self.ref_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.amplitude_to_DB(x, self.multiplier, self.amin, self.db_multiplier, self.top_db)


class MelScale(nn.Module):
    """Spectrogram (..., n_stft, frames) -> mel spectrogram (..., n_mels, frames)."""

    def __init__(
        self,
        n_mels: int = 128,
        sample_rate: int = 16000,
        f_min: float = 0.0,
        f_max: Optional[float] = None,
        n_stft: int = 201,
        norm: Optional[str] = None,
        mel_scale: str = "htk",
        device="cuda",
    ) -> None:
        super().__init__()
        self.n_mels = n_mels
        self.sample_rate = sample_rate
        self.f_max = f_max if f_max is not None else float(sample_rate // 2)
        self.f_min = f_min
        if f_min > self.f_max:
            raise ValueError(f"Require f_min: {f_min} <= f_max: {self.f_max}")
        self.register_buffer(
            "fb", F.melscale_fbanks(n_stft, self.f_min, self.f_max, self.n_mels, self.sample_rate, norm, mel_scale,
                                    device=device),
            persistent=False)

    def forward(self, specgram: torch.Tensor) -> torch.Tensor:
        return _bank(specgram, self.fb)


class InverseMelScale(nn.Module):
    """Least-squares inversion of the mel filterbank, clamped at 0: (..., n_mels, frames) -> (..., n_stft, frames).

    ``fb_pinv`` is made once, on the host in float32 as the JAX package makes
    it: for ``"gels"`` from the QR factors of the bank (a rank-deficient bank
    raises ``RuntimeError`` here), for the rank-revealing drivers from its
    pseudo-inverse.
    """

    def __init__(
        self,
        n_stft: int,
        n_mels: int = 128,
        sample_rate: int = 16000,
        f_min: float = 0.0,
        f_max: Optional[float] = None,
        norm: Optional[str] = None,
        mel_scale: str = "htk",
        driver: str = "gels",
        device="cuda",
    ) -> None:
        super().__init__()
        self.n_mels = n_mels
        self.sample_rate = sample_rate
        self.f_max = f_max or float(sample_rate // 2)
        self.f_min = f_min
        self.driver = driver
        if f_min > self.f_max:
            raise ValueError(f"Require f_min: {f_min} <= f_max: {self.f_max}")
        if driver not in ("gels", "gelsy", "gelsd", "gelss"):
            raise ValueError(f'driver must be one of ["gels", "gelsy", "gelsd", "gelss"]. Found {driver}.')
        fb = F.melscale_fbanks(n_stft, self.f_min, self.f_max, self.n_mels, self.sample_rate, norm, mel_scale,
                               device="cpu")
        a = fb.T  # (n_mels, freq): solve a @ spec = mel per time column
        if driver == "gels":
            # the minimum-norm solution x = Q R^-T b with a.T = QR, the path LAPACK's gels takes for a
            # wide system; a rank-deficient bank is an error, as in torch.linalg.lstsq(driver="gels")
            q, r = torch.linalg.qr(a.T)  # (freq, n_mels), (n_mels, n_mels)
            diag = torch.abs(torch.diagonal(r))
            if float(diag.min()) <= 1e-7 * float(diag.max()):
                raise RuntimeError(
                    "InverseMelScale(driver='gels'): the mel filterbank does "
                    "not have full rank; use a rank-revealing driver "
                    "('gelsd'/'gelss'/'gelsy')"
                )
            rinvt = torch.linalg.solve_triangular(r.T, torch.eye(r.shape[0], dtype=r.dtype), upper=False)
            fb_pinv = q @ rinvt  # (freq, n_mels)
        else:
            # the JAX package's cutoff for small singular values, 10 max(m, n) eps
            fb_pinv = torch.linalg.pinv(a, rtol=10 * max(a.shape) * torch.finfo(a.dtype).eps)  # (freq, n_mels)
        self.register_buffer("fb", fb.to(device), persistent=False)
        self.register_buffer("fb_pinv", fb_pinv.to(device), persistent=False)

    def forward(self, melspec: torch.Tensor) -> torch.Tensor:
        if melspec.shape[-2] != self.n_mels:
            raise ValueError(f"Expected an input with {self.n_mels} mel bins. Found: {melspec.shape[-2]}")
        # the bank's float32 and the input's dtype promote, as the JAX package's einsum promotes them
        dtype = torch.promote_types(self.fb_pinv.dtype, melspec.dtype)
        return torch.relu(exact_matmul(self.fb_pinv.to(dtype), melspec.to(dtype)))


class MelSpectrogram(nn.Module):
    """Mel power spectrogram of a waveform (..., time) -> (..., n_mels, frames).

    The same parameters and layout as ``audio_tpu.transforms.MelSpectrogram``
    (``onesided`` is accepted and, as there, has no effect).  Framing,
    windowed DFT, power and the mel product run in one call of
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
        onesided: Optional[bool] = None,
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
            return _bank(spec, self.fb)
        if self.pad > 0:
            waveform = torch.nn.functional.pad(waveform, (self.pad, self.pad))
        return F.mel_spectrogram(
            waveform, fb=self.fb.to(waveform.dtype), window=self.window, n_fft=self.n_fft,
            hop_length=self.hop_length, win_length=self.win_length, center=self.center, pad_mode=self.pad_mode,
            power=2.0, normalized=self.normalized)


class MFCC(nn.Module):
    """Mel-frequency cepstral coefficients (..., time) -> (..., n_mfcc, frames).

    The mel spectrogram is a ``MelSpectrogram`` (kernel K2 on the card at
    power 2), then decibels (``top_db`` 80, the floor taken per clip over the
    last three axes) or a log, then the DCT product.
    """

    def __init__(
        self,
        sample_rate: int = 16000,
        n_mfcc: int = 40,
        dct_type: int = 2,
        norm: str = "ortho",
        log_mels: bool = False,
        melkwargs: Optional[dict] = None,
        device="cuda",
    ) -> None:
        super().__init__()
        if dct_type != 2:
            raise ValueError(f"DCT type not supported: {dct_type}")
        self.sample_rate = sample_rate
        self.n_mfcc = n_mfcc
        self.dct_type = dct_type
        self.norm = norm
        self.top_db = 80.0
        self.amplitude_to_DB = AmplitudeToDB("power", self.top_db)
        self.MelSpectrogram = MelSpectrogram(sample_rate=sample_rate, **(melkwargs or {}), device=device)
        if self.n_mfcc > self.MelSpectrogram.n_mels:
            raise ValueError("Cannot select more MFCC coefficients than # mel bins")
        self.register_buffer("dct_mat", F.create_dct(self.n_mfcc, self.MelSpectrogram.n_mels, self.norm,
                                                     device=device), persistent=False)
        self.log_mels = log_mels

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        mel_specgram = self.MelSpectrogram(waveform)
        if self.log_mels:
            mel_specgram = torch.log(mel_specgram + 1e-6)
        else:
            mel_specgram = self.amplitude_to_DB(mel_specgram)
        return _bank(mel_specgram, self.dct_mat)


class LFCC(nn.Module):
    """Linear-frequency cepstral coefficients (..., time) -> (..., n_lfcc, frames).

    The spectrogram is a ``Spectrogram`` (kernel K2's power path on the card
    at power 2), then the linear filterbank product, decibels or a log, then
    the DCT product.
    """

    def __init__(
        self,
        sample_rate: int = 16000,
        n_filter: int = 128,
        f_min: float = 0.0,
        f_max: Optional[float] = None,
        n_lfcc: int = 40,
        dct_type: int = 2,
        norm: str = "ortho",
        log_lf: bool = False,
        speckwargs: Optional[dict] = None,
        device="cuda",
    ) -> None:
        super().__init__()
        if dct_type != 2:
            raise ValueError(f"DCT type not supported: {dct_type}")
        self.sample_rate = sample_rate
        self.f_min = f_min
        self.f_max = f_max if f_max is not None else float(sample_rate // 2)
        self.n_filter = n_filter
        self.n_lfcc = n_lfcc
        self.top_db = 80.0
        self.amplitude_to_DB = AmplitudeToDB("power", self.top_db)
        self.Spectrogram = Spectrogram(**(speckwargs or {}), device=device)
        if self.n_lfcc > self.Spectrogram.n_fft:
            raise ValueError("Cannot select more LFCC coefficients than # fft bins")
        self.register_buffer("filter_mat", F.linear_fbanks(
            n_freqs=self.Spectrogram.n_fft // 2 + 1, f_min=self.f_min, f_max=self.f_max, n_filter=self.n_filter,
            sample_rate=self.sample_rate, device=device), persistent=False)
        self.register_buffer("dct_mat", F.create_dct(self.n_lfcc, self.n_filter, norm, device=device),
                             persistent=False)
        self.log_lf = log_lf

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        specgram = _bank(self.Spectrogram(waveform), self.filter_mat)
        if self.log_lf:
            specgram = torch.log(specgram + 1e-6)
        else:
            specgram = self.amplitude_to_DB(specgram)
        return _bank(specgram, self.dct_mat)


class MuLawEncoding(nn.Module):
    def __init__(self, quantization_channels: int = 256) -> None:
        super().__init__()
        self.quantization_channels = quantization_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.mu_law_encoding(x, self.quantization_channels)


class MuLawDecoding(nn.Module):
    def __init__(self, quantization_channels: int = 256) -> None:
        super().__init__()
        self.quantization_channels = quantization_channels

    def forward(self, x_mu: torch.Tensor) -> torch.Tensor:
        return F.mu_law_decoding(x_mu, self.quantization_channels)


class Resample(nn.Module):
    """Bandlimited resampling with its polyphase kernel built once, at construction (on the host in
    float64, then cast to ``dtype`` and made a buffer on ``device``)."""

    def __init__(
        self,
        orig_freq: int = 16000,
        new_freq: int = 16000,
        resampling_method: str = "sinc_interp_hann",
        lowpass_filter_width: int = 6,
        rolloff: float = 0.99,
        beta: Optional[float] = None,
        dtype=torch.float32,
        device="cuda",
    ) -> None:
        super().__init__()
        self.orig_freq = orig_freq
        self.new_freq = new_freq
        self.gcd = math.gcd(int(orig_freq), int(new_freq))
        self.resampling_method = resampling_method
        self.lowpass_filter_width = lowpass_filter_width
        self.rolloff = rolloff
        self.beta = beta
        if self.orig_freq != self.new_freq:
            kernel, self.width = get_sinc_resample_kernel(
                orig_freq, new_freq, self.gcd, lowpass_filter_width, rolloff, resampling_method, beta, dtype=dtype
            )
            self.register_buffer("kernel", kernel.to(device), persistent=False)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        if self.orig_freq == self.new_freq:
            return waveform
        return apply_sinc_resample_kernel(waveform, self.orig_freq, self.new_freq, self.gcd, self.kernel, self.width)


class ComputeDeltas(nn.Module):
    def __init__(self, win_length: int = 5, mode: str = "replicate") -> None:
        super().__init__()
        self.win_length = win_length
        self.mode = mode

    def forward(self, specgram: torch.Tensor) -> torch.Tensor:
        return F.compute_deltas(specgram, win_length=self.win_length, mode=self.mode)


class TimeStretch(nn.Module):
    """Phase-vocoder time stretch of a complex spectrogram.

    ``phase_advance`` is a float32 buffer, torchaudio's (the JAX package's
    ``jnp.linspace`` is float64 when JAX runs with 64-bit types).
    """

    def __init__(self, hop_length: Optional[int] = None, n_freq: int = 201, fixed_rate: Optional[float] = None,
                 device="cuda") -> None:
        super().__init__()
        n_fft = (n_freq - 1) * 2
        hop_length = hop_length if hop_length is not None else n_fft // 2
        self.fixed_rate = fixed_rate
        self.register_buffer(
            "phase_advance",
            torch.linspace(0, math.pi * hop_length, n_freq, dtype=torch.float32, device=device)[..., None],
            persistent=False)

    def forward(self, complex_specgrams: torch.Tensor, overriding_rate: Optional[float] = None) -> torch.Tensor:
        rate = overriding_rate if overriding_rate is not None else self.fixed_rate
        if rate is None:
            raise ValueError("If no fixed_rate is specified, must pass a valid rate to the forward method.")
        return F.phase_vocoder(complex_specgrams, rate, self.phase_advance)


_FADE_IN = {
    "linear": lambda f: f,
    "exponential": lambda f: torch.pow(2, f - 1) * f,
    "logarithmic": lambda f: torch.log10(0.1 + f) + 1,
    "quarter_sine": lambda f: torch.sin(f * math.pi / 2),
    "half_sine": lambda f: torch.sin(f * math.pi - math.pi / 2) / 2 + 0.5,
}
_FADE_OUT = {
    "linear": lambda f: -f + 1,
    "exponential": lambda f: torch.pow(2, -f) * (1 - f),
    "logarithmic": lambda f: torch.log10(1.1 - f) + 1,
    "quarter_sine": lambda f: torch.sin(f * math.pi / 2 + math.pi / 2),
    "half_sine": lambda f: torch.sin(f * math.pi + math.pi / 2) / 2 + 0.5,
}


class Fade(nn.Module):
    """Fade in and out over the last axis; the ramps are built in at least float32 on the
    waveform's device, and the product is cast back to the waveform's dtype."""

    def __init__(self, fade_in_len: int = 0, fade_out_len: int = 0, fade_shape: str = "linear") -> None:
        super().__init__()
        self.fade_in_len = fade_in_len
        self.fade_out_len = fade_out_len
        self.fade_shape = fade_shape

    def _shape(self, table: dict, fade: torch.Tensor) -> torch.Tensor:
        if self.fade_shape not in table:
            raise ValueError(f"Unknown fade_shape {self.fade_shape}")
        return table[self.fade_shape](fade)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        length = waveform.shape[-1]
        kw = dict(dtype=torch.promote_types(waveform.dtype, torch.float32), device=waveform.device)
        fade_in = torch.clamp(torch.cat([self._shape(_FADE_IN, torch.linspace(0, 1, self.fade_in_len, **kw)),
                                         torch.ones(length - self.fade_in_len, **kw)]), 0, 1)
        fade_out = torch.clamp(torch.cat([torch.ones(length - self.fade_out_len, **kw),
                                          self._shape(_FADE_OUT, torch.linspace(0, 1, self.fade_out_len, **kw))]),
                               0, 1)
        return (waveform * fade_in * fade_out).to(waveform.dtype)


class _AxisMasking(nn.Module):
    def __init__(self, mask_param: int, axis: int, iid_masks: bool, p: float = 1.0) -> None:
        super().__init__()
        self.mask_param = mask_param
        self.axis = axis
        self.iid_masks = iid_masks
        self.p = p

    def forward(self, specgram: torch.Tensor, mask_value: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.iid_masks and specgram.dim() == 4:
            return F.mask_along_axis_iid(specgram, self.mask_param, mask_value, self.axis + 1, p=self.p,
                                         generator=generator)
        return F.mask_along_axis(specgram, self.mask_param, mask_value, self.axis, p=self.p, generator=generator)


class FrequencyMasking(_AxisMasking):
    def __init__(self, freq_mask_param: int, iid_masks: bool = False) -> None:
        super().__init__(freq_mask_param, 1, iid_masks)


class TimeMasking(_AxisMasking):
    def __init__(self, time_mask_param: int, iid_masks: bool = False, p: float = 1.0) -> None:
        super().__init__(time_mask_param, 2, iid_masks, p=p)


class SpecAugment(nn.Module):
    """Time masks, then frequency masks, every span drawn from the one ``generator`` in that order;
    the fill is the spectrogram's mean unless ``zero_masking``."""

    def __init__(
        self,
        n_time_masks: int,
        time_mask_param: int,
        n_freq_masks: int,
        freq_mask_param: int,
        iid_masks: bool = True,
        p: float = 1.0,
        zero_masking: bool = False,
    ) -> None:
        super().__init__()
        self.n_time_masks = n_time_masks
        self.time_mask_param = time_mask_param
        self.n_freq_masks = n_freq_masks
        self.freq_mask_param = freq_mask_param
        self.iid_masks = iid_masks
        self.p = p
        self.zero_masking = zero_masking

    def forward(self, specgram: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        generator = _default_generator(generator, specgram.device)
        mask_value = 0.0 if self.zero_masking else specgram.mean()
        time_dim = specgram.dim() - 1
        freq_dim = time_dim - 1
        mask = F.mask_along_axis_iid if specgram.dim() > 2 and self.iid_masks else F.mask_along_axis
        for param, dim, n in ((self.time_mask_param, time_dim, self.n_time_masks),
                              (self.freq_mask_param, freq_dim, self.n_freq_masks)):
            for _ in range(n):
                specgram = mask(specgram, param, mask_value, dim, p=self.p, generator=generator)
        return specgram


class Loudness(nn.Module):
    def __init__(self, sample_rate: int):
        super().__init__()
        self.sample_rate = sample_rate

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return F.loudness(waveform, self.sample_rate)


class Vol(nn.Module):
    def __init__(self, gain: float, gain_type: str = "amplitude"):
        super().__init__()
        self.gain = gain
        self.gain_type = gain_type
        if gain_type in ("amplitude", "power") and gain < 0:
            raise ValueError("If gain_type = amplitude or power, gain must be positive.")

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        if self.gain_type == "amplitude":
            waveform = waveform * self.gain
        elif self.gain_type == "db":
            waveform = F.gain(waveform, self.gain)
        elif self.gain_type == "power":
            waveform = F.gain(waveform, 10 * math.log10(self.gain))
        return torch.clamp(waveform, -1, 1)


class SlidingWindowCmn(nn.Module):
    def __init__(
        self, cmn_window: int = 600, min_cmn_window: int = 100, center: bool = False, norm_vars: bool = False
    ) -> None:
        super().__init__()
        self.cmn_window = cmn_window
        self.min_cmn_window = min_cmn_window
        self.center = center
        self.norm_vars = norm_vars

    def forward(self, specgram: torch.Tensor) -> torch.Tensor:
        return F.sliding_window_cmn(specgram, self.cmn_window, self.min_cmn_window, self.center, self.norm_vars)


class SpectralCentroid(nn.Module):
    """Spectral centroid in Hz per frame; its magnitude spectrogram runs kernel K2 on the card."""

    def __init__(
        self,
        sample_rate: int,
        n_fft: int = 400,
        win_length: Optional[int] = None,
        hop_length: Optional[int] = None,
        pad: int = 0,
        window_fn: Callable = hann_window,
        wkwargs: Optional[dict] = None,
        device="cuda",
    ) -> None:
        super().__init__()
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.win_length = win_length if win_length is not None else n_fft
        self.hop_length = hop_length if hop_length is not None else self.win_length // 2
        self.pad = pad
        self.register_buffer("window", window_fn(self.win_length, device=device, **(wkwargs or {})),
                             persistent=False)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return F.spectral_centroid(
            waveform, self.sample_rate, self.pad, self.window, self.n_fft, self.hop_length, self.win_length
        )


class PitchShift(nn.Module):
    """Pitch shift by ``n_steps``; as in the JAX package, the resampling kernel is built on every call."""

    def __init__(
        self,
        sample_rate: int,
        n_steps: int,
        bins_per_octave: int = 12,
        n_fft: int = 512,
        win_length: Optional[int] = None,
        hop_length: Optional[int] = None,
        window_fn: Callable = hann_window,
        wkwargs: Optional[dict] = None,
        device="cuda",
    ) -> None:
        super().__init__()
        self.sample_rate = sample_rate
        self.n_steps = n_steps
        self.bins_per_octave = bins_per_octave
        self.n_fft = n_fft
        self.win_length = win_length if win_length is not None else n_fft
        self.hop_length = hop_length if hop_length is not None else self.win_length // 4
        self.register_buffer("window", window_fn(self.win_length, device=device, **(wkwargs or {})),
                             persistent=False)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return F.pitch_shift(
            waveform, self.sample_rate, self.n_steps, self.bins_per_octave, self.n_fft, self.win_length,
            self.hop_length, self.window,
        )


class RNNTLoss(nn.Module):
    """The RNN transducer loss; its lattice statistics run kernel K8 on the card."""

    def __init__(
        self, blank: int = -1, clamp: float = -1.0, reduction: str = "mean", fused_log_softmax: bool = True
    ) -> None:
        super().__init__()
        self.blank = blank
        self.clamp = clamp
        self.reduction = reduction
        self.fused_log_softmax = fused_log_softmax

    def forward(self, logits, targets, logit_lengths, target_lengths):
        return F.rnnt_loss(
            logits, targets, logit_lengths, target_lengths, self.blank, self.clamp, self.reduction,
            self.fused_log_softmax,
        )


class Convolve(nn.Module):
    def __init__(self, mode: str = "full") -> None:
        super().__init__()
        self.mode = mode

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return F.convolve(x, y, mode=self.mode)


class FFTConvolve(nn.Module):
    def __init__(self, mode: str = "full") -> None:
        super().__init__()
        self.mode = mode

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return F.fftconvolve(x, y, mode=self.mode)


class Speed(nn.Module):
    """Speed change by ``factor`` through a ``Resample`` built once; integer lengths scale by an
    exact integer ceiling division."""

    def __init__(self, orig_freq: int, factor: float, device="cuda") -> None:
        super().__init__()
        self.orig_freq = orig_freq
        self.factor = factor
        self.source_sample_rate, self.target_sample_rate = _speed_rates(orig_freq, factor)
        self.resampler = Resample(orig_freq=self.source_sample_rate, new_freq=self.target_sample_rate, device=device)

    def forward(
        self, waveform: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self.resampler(waveform), _speed_lengths(lengths, self.source_sample_rate, self.target_sample_rate)


class SpeedPerturbation(nn.Module):
    """One of ``factors``' ``Speed`` modules, chosen by a draw from ``generator`` (one host read a call)."""

    def __init__(self, orig_freq: int, factors: Sequence[float], device="cuda") -> None:
        super().__init__()
        self.speeders = nn.ModuleList([Speed(orig_freq=orig_freq, factor=factor, device=device) for factor in factors])

    def forward(
        self, waveform: torch.Tensor, lengths: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        generator = _default_generator(generator, waveform.device)
        idx = int(torch.randint(0, len(self.speeders), (), generator=generator, device=generator.device))
        return self.speeders[idx](waveform, lengths)


class AddNoise(nn.Module):
    def forward(
        self, waveform: torch.Tensor, noise: torch.Tensor, snr: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return F.add_noise(waveform, noise, snr, lengths)


class Preemphasis(nn.Module):
    def __init__(self, coeff: float = 0.97) -> None:
        super().__init__()
        self.coeff = coeff

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return F.preemphasis(waveform, coeff=self.coeff)


class Deemphasis(nn.Module):
    """The inverse of ``Preemphasis``, through ``lfilter``: kernel K1 on the card."""

    def __init__(self, coeff: float = 0.97) -> None:
        super().__init__()
        self.coeff = coeff

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return F.deemphasis(waveform, coeff=self.coeff)


class Vad(nn.Module):
    """Voice activity detector (sox vad semantics); ``kwargs`` are ``functional.vad``'s."""

    def __init__(self, sample_rate: int, **kwargs) -> None:
        super().__init__()
        self.sample_rate = sample_rate
        self.kwargs = kwargs

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return F.vad(waveform, self.sample_rate, **self.kwargs)
