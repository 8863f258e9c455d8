"""Kaldi-compatible features (spectrogram, fbank, mfcc) of the PyTorch port.

The same functions, parameters and defaults as ``audio_tpu.compliance.kaldi``:
Kaldi's framing (``snip_edges``, or the signal mirrored at both ends), dither,
per-frame DC removal, raw energy, pre-emphasis, the povey, hamming, hanning,
blackman and rectangular windows, zero padding to a power of two, the Kaldi
mel scale 1127 ln(1 + f/700) with VTLN warping, the DCT with Kaldi's C0 and
the cepstral lifter, and the ``htk_compat`` column order.  Each computes on
its waveform's device: frames are a strided view, the FFT is
``torch.fft.rfft`` and the mel and DCT products are exact float32
(``utils.precision.exact_matmul``); the windows, the mel banks and the lifter
are made on the host in float64 and cast.  No kernel of the port is on this
path (the JAX package's features are ``jnp.fft`` and a product too).  Dither
draws from a ``torch.Generator`` where the JAX package takes a key: ``None``
means a generator seeded 0 on the waveform's device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..functional._fbanks import create_dct
from ..utils.precision import exact_matmul

__all__ = [
    "get_mel_banks",
    "inverse_mel_scale",
    "inverse_mel_scale_scalar",
    "mel_scale",
    "mel_scale_scalar",
    "spectrogram",
    "fbank",
    "mfcc",
    "vtln_warp_freq",
    "vtln_warp_mel_freq",
]

EPSILON = float(np.finfo(np.float32).eps)
MILLISECONDS_TO_SECONDS = 0.001

HAMMING = "hamming"
HANNING = "hanning"
POVEY = "povey"
RECTANGULAR = "rectangular"
BLACKMAN = "blackman"
WINDOWS = [HAMMING, HANNING, POVEY, RECTANGULAR, BLACKMAN]


def _next_power_of_2(x: int) -> int:
    return 1 if x == 0 else 2 ** (x - 1).bit_length()


def _check(condition: bool, message: str) -> None:
    if not condition:
        raise ValueError(message)


def _get_strided(waveform: torch.Tensor, window_size: int, window_shift: int, snip_edges: bool) -> torch.Tensor:
    """Frame a 1D waveform into (m, window_size) rows, Kaldi edge semantics (a view where it can be)."""
    num_samples = waveform.shape[0]
    if snip_edges:
        if num_samples < window_size:
            return torch.empty((0, window_size), dtype=waveform.dtype, device=waveform.device)
        m = 1 + (num_samples - window_size) // window_shift
    else:
        reversed_waveform = torch.flip(waveform, (0,))
        m = (num_samples + (window_shift // 2)) // window_shift
        pad = window_size // 2 - window_shift // 2
        if pad > 0:
            waveform = torch.cat([reversed_waveform[-pad:], waveform, reversed_waveform])
        else:
            waveform = torch.cat([waveform[-pad:], reversed_waveform])
    return waveform.unfold(0, window_size, window_shift)[:m]


def _feature_window_function(window_type: str, window_size: int, blackman_coeff: float, dtype,
                             device) -> torch.Tensor:
    n = np.arange(window_size, dtype=np.float64)
    if window_type == HANNING:
        w = 0.5 - 0.5 * np.cos(2 * math.pi * n / (window_size - 1))
    elif window_type == HAMMING:
        w = 0.54 - 0.46 * np.cos(2 * math.pi * n / (window_size - 1))
    elif window_type == POVEY:
        w = (0.5 - 0.5 * np.cos(2 * math.pi * n / (window_size - 1))) ** 0.85
    elif window_type == RECTANGULAR:
        w = np.ones(window_size)
    elif window_type == BLACKMAN:
        a = 2 * math.pi / (window_size - 1)
        w = blackman_coeff - 0.5 * np.cos(a * n) + (0.5 - blackman_coeff) * np.cos(2 * a * n)
    else:
        raise ValueError("Invalid window type " + window_type)
    return torch.as_tensor(w, dtype=dtype, device=device)


def _get_log_energy(strided_input: torch.Tensor, energy_floor: float) -> torch.Tensor:
    log_energy = torch.log(torch.clamp(torch.sum(strided_input**2, 1), min=EPSILON))
    if energy_floor == 0.0:
        return log_energy
    return torch.clamp(log_energy, min=math.log(energy_floor))


def _get_waveform_and_window_properties(
    waveform: torch.Tensor,
    channel: int,
    sample_frequency: float,
    frame_shift: float,
    frame_length: float,
    round_to_power_of_two: bool,
    preemphasis_coefficient: float,
) -> Tuple[torch.Tensor, int, int, int]:
    channel = max(channel, 0)
    _check(channel < waveform.shape[0], f"Invalid channel {channel} for size {waveform.shape[0]}")
    waveform = waveform[channel, :]
    window_shift = int(sample_frequency * frame_shift * MILLISECONDS_TO_SECONDS)
    window_size = int(sample_frequency * frame_length * MILLISECONDS_TO_SECONDS)
    padded_window_size = _next_power_of_2(window_size) if round_to_power_of_two else window_size
    _check(2 <= window_size <= waveform.shape[0],
           f"choose a window size {window_size} that is [2, {waveform.shape[0]}]")
    _check(window_shift > 0, "`window_shift` must be greater than 0")
    _check(padded_window_size % 2 == 0, "the padded window size must be even")
    _check(0.0 <= preemphasis_coefficient <= 1.0, "`preemphasis_coefficient` must be in [0, 1]")
    _check(sample_frequency > 0, "`sample_frequency` must be greater than 0")
    return waveform, window_shift, window_size, padded_window_size


def _get_window(
    waveform: torch.Tensor,
    padded_window_size: int,
    window_size: int,
    window_shift: int,
    window_type: str,
    blackman_coeff: float,
    snip_edges: bool,
    raw_energy: bool,
    energy_floor: float,
    dither: float,
    remove_dc_offset: bool,
    preemphasis_coefficient: float,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    strided_input = _get_strided(waveform, window_size, window_shift, snip_edges)

    if dither != 0.0:
        if generator is None:
            generator = torch.Generator(device=strided_input.device).manual_seed(0)
        noise = torch.randn(strided_input.shape, generator=generator, dtype=strided_input.dtype,
                            device=generator.device)
        strided_input = strided_input + noise.to(strided_input.device) * dither

    if remove_dc_offset:
        strided_input = strided_input - torch.mean(strided_input, dim=1, keepdim=True)

    if raw_energy:
        signal_log_energy = _get_log_energy(strided_input, energy_floor)

    if preemphasis_coefficient != 0.0:
        offset = torch.cat([strided_input[:, :1], strided_input[:, :-1]], dim=1)  # the edge pad
        strided_input = strided_input - preemphasis_coefficient * offset

    window_function = _feature_window_function(window_type, window_size, blackman_coeff, strided_input.dtype,
                                                strided_input.device)
    strided_input = strided_input * window_function[None, :]

    if padded_window_size != window_size:
        strided_input = torch.nn.functional.pad(strided_input, (0, padded_window_size - window_size))

    if not raw_energy:
        signal_log_energy = _get_log_energy(strided_input, energy_floor)

    return strided_input, signal_log_energy


def _subtract_column_mean(tensor: torch.Tensor, subtract_mean: bool) -> torch.Tensor:
    if subtract_mean:
        tensor = tensor - torch.mean(tensor, dim=0, keepdim=True)
    return tensor


def spectrogram(
    waveform: torch.Tensor,
    blackman_coeff: float = 0.42,
    channel: int = -1,
    dither: float = 0.0,
    energy_floor: float = 1.0,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    min_duration: float = 0.0,
    preemphasis_coefficient: float = 0.97,
    raw_energy: bool = True,
    remove_dc_offset: bool = True,
    round_to_power_of_two: bool = True,
    sample_frequency: float = 16000.0,
    snip_edges: bool = True,
    subtract_mean: bool = False,
    window_type: str = POVEY,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Kaldi compute-spectrogram-feats; returns (m, padded_window_size//2+1)."""
    waveform, window_shift, window_size, padded_window_size = _get_waveform_and_window_properties(
        waveform, channel, sample_frequency, frame_shift, frame_length, round_to_power_of_two, preemphasis_coefficient
    )
    if waveform.shape[0] < min_duration * sample_frequency:
        return torch.empty((0,), device=waveform.device)

    strided_input, signal_log_energy = _get_window(
        waveform, padded_window_size, window_size, window_shift, window_type, blackman_coeff,
        snip_edges, raw_energy, energy_floor, dither, remove_dc_offset, preemphasis_coefficient, generator,
    )
    fft = torch.fft.rfft(strided_input)
    power_spectrum = torch.log(torch.clamp(torch.abs(fft) ** 2.0, min=EPSILON))
    power_spectrum = torch.cat([signal_log_energy[:, None], power_spectrum[:, 1:]], dim=1)
    return _subtract_column_mean(power_spectrum, subtract_mean)


def inverse_mel_scale_scalar(mel_freq: float) -> float:
    return 700.0 * (math.exp(mel_freq / 1127.0) - 1.0)


def inverse_mel_scale(mel_freq: torch.Tensor) -> torch.Tensor:
    return 700.0 * (torch.exp(mel_freq / 1127.0) - 1.0)


def mel_scale_scalar(freq: float) -> float:
    return 1127.0 * math.log(1.0 + freq / 700.0)


def mel_scale(freq: torch.Tensor) -> torch.Tensor:
    return 1127.0 * torch.log(1.0 + freq / 700.0)


def vtln_warp_freq(
    vtln_low_cutoff: float,
    vtln_high_cutoff: float,
    low_freq: float,
    high_freq: float,
    vtln_warp_factor: float,
    freq: torch.Tensor,
) -> torch.Tensor:
    """Kaldi's piecewise-linear VTLN warping function."""
    _check(vtln_low_cutoff > low_freq, "be sure to set the vtln_low option higher than low_freq")
    _check(vtln_high_cutoff < high_freq, "be sure to set the vtln_high option lower than high_freq [or negative]")
    l = vtln_low_cutoff * max(1.0, vtln_warp_factor)  # noqa: E741
    h = vtln_high_cutoff * min(1.0, vtln_warp_factor)
    scale = 1.0 / vtln_warp_factor
    fl = scale * l
    fh = scale * h
    _check(l > low_freq and h < high_freq, "the warped cutoffs must lie inside (low_freq, high_freq)")
    scale_left = (fl - low_freq) / (l - low_freq)
    scale_right = (high_freq - fh) / (high_freq - h)

    res = torch.where(freq >= h, high_freq + scale_right * (freq - high_freq), freq)
    res = torch.where(freq < h, scale * freq, res)
    res = torch.where(freq < l, low_freq + scale_left * (freq - low_freq), res)
    outside = (freq < low_freq) | (freq > high_freq)
    return torch.where(outside, freq, res)


def vtln_warp_mel_freq(
    vtln_low_cutoff: float,
    vtln_high_cutoff: float,
    low_freq: float,
    high_freq: float,
    vtln_warp_factor: float,
    mel_freq: torch.Tensor,
) -> torch.Tensor:
    return mel_scale(vtln_warp_freq(vtln_low_cutoff, vtln_high_cutoff, low_freq, high_freq, vtln_warp_factor,
                                    inverse_mel_scale(mel_freq)))


def get_mel_banks(
    num_bins: int,
    window_length_padded: int,
    sample_freq: float,
    low_freq: float,
    high_freq: float,
    vtln_low: float,
    vtln_high: float,
    vtln_warp_factor: float,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kaldi mel banks of size (num_bins, window_length_padded//2) and their centre frequencies, in
    float64: computed on the host, then moved to ``device``."""
    _check(num_bins > 3, "Must have at least 3 mel bins")
    _check(window_length_padded % 2 == 0, "the padded window length must be even")
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq += nyquist
    _check((0.0 <= low_freq < nyquist) and (0.0 < high_freq <= nyquist) and (low_freq < high_freq),
           f"Bad values in options: low-freq {low_freq} and high-freq {high_freq} vs. nyquist {nyquist}")
    fft_bin_width = sample_freq / window_length_padded
    mel_low_freq = mel_scale_scalar(low_freq)
    mel_high_freq = mel_scale_scalar(high_freq)
    mel_freq_delta = (mel_high_freq - mel_low_freq) / (num_bins + 1)
    if vtln_high < 0.0:
        vtln_high += nyquist
    _check(vtln_warp_factor == 1.0 or (
        (low_freq < vtln_low < high_freq) and (0.0 < vtln_high < high_freq) and (vtln_low < vtln_high)),
        f"Bad values in options: vtln-low {vtln_low} and vtln-high {vtln_high}, versus low-freq {low_freq} and "
        f"high-freq {high_freq}")

    bin_idx = torch.arange(num_bins, dtype=torch.float64)[:, None]
    left_mel = mel_low_freq + bin_idx * mel_freq_delta
    center_mel = mel_low_freq + (bin_idx + 1.0) * mel_freq_delta
    right_mel = mel_low_freq + (bin_idx + 2.0) * mel_freq_delta

    if vtln_warp_factor != 1.0:
        left_mel = vtln_warp_mel_freq(vtln_low, vtln_high, low_freq, high_freq, vtln_warp_factor, left_mel)
        center_mel = vtln_warp_mel_freq(vtln_low, vtln_high, low_freq, high_freq, vtln_warp_factor, center_mel)
        right_mel = vtln_warp_mel_freq(vtln_low, vtln_high, low_freq, high_freq, vtln_warp_factor, right_mel)

    center_freqs = inverse_mel_scale(center_mel)[:, 0]
    mel = mel_scale(fft_bin_width * torch.arange(num_fft_bins, dtype=torch.float64))[None, :]

    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)

    if vtln_warp_factor == 1.0:
        bins = torch.clamp(torch.minimum(up_slope, down_slope), min=0.0)
    else:
        bins = torch.zeros_like(up_slope)
        up_idx = (mel > left_mel) & (mel <= center_mel)
        down_idx = (mel > center_mel) & (mel < right_mel)
        bins = torch.where(up_idx, up_slope, bins)
        bins = torch.where(down_idx, down_slope, bins)
    return bins.to(device), center_freqs.to(device)


def fbank(
    waveform: torch.Tensor,
    blackman_coeff: float = 0.42,
    channel: int = -1,
    dither: float = 0.0,
    energy_floor: float = 1.0,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    high_freq: float = 0.0,
    htk_compat: bool = False,
    low_freq: float = 20.0,
    min_duration: float = 0.0,
    num_mel_bins: int = 23,
    preemphasis_coefficient: float = 0.97,
    raw_energy: bool = True,
    remove_dc_offset: bool = True,
    round_to_power_of_two: bool = True,
    sample_frequency: float = 16000.0,
    snip_edges: bool = True,
    subtract_mean: bool = False,
    use_energy: bool = False,
    use_log_fbank: bool = True,
    use_power: bool = True,
    vtln_high: float = -500.0,
    vtln_low: float = 100.0,
    vtln_warp: float = 1.0,
    window_type: str = POVEY,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Kaldi compute-fbank-feats; returns (m, num_mel_bins [+ energy])."""
    waveform, window_shift, window_size, padded_window_size = _get_waveform_and_window_properties(
        waveform, channel, sample_frequency, frame_shift, frame_length, round_to_power_of_two, preemphasis_coefficient
    )
    if waveform.shape[0] < min_duration * sample_frequency:
        return torch.empty((0,), device=waveform.device)

    strided_input, signal_log_energy = _get_window(
        waveform, padded_window_size, window_size, window_shift, window_type, blackman_coeff,
        snip_edges, raw_energy, energy_floor, dither, remove_dc_offset, preemphasis_coefficient, generator,
    )
    spectrum = torch.abs(torch.fft.rfft(strided_input))
    if use_power:
        spectrum = spectrum**2.0

    mel_energies, _ = get_mel_banks(
        num_mel_bins, padded_window_size, sample_frequency, low_freq, high_freq, vtln_low, vtln_high, vtln_warp,
        device=spectrum.device,
    )
    mel_energies = torch.nn.functional.pad(mel_energies.to(spectrum.dtype), (0, 1))
    mel_energies = exact_matmul(spectrum, mel_energies.T)
    if use_log_fbank:
        mel_energies = torch.log(torch.clamp(mel_energies, min=EPSILON))

    if use_energy:
        e = signal_log_energy[:, None]
        if htk_compat:
            mel_energies = torch.cat([mel_energies, e], dim=1)
        else:
            mel_energies = torch.cat([e, mel_energies], dim=1)

    return _subtract_column_mean(mel_energies, subtract_mean)


def _get_dct_matrix(num_ceps: int, num_mel_bins: int, dtype, device) -> torch.Tensor:
    dct_matrix = create_dct(num_mel_bins, num_mel_bins, "ortho", device="cpu").numpy().copy()
    dct_matrix[:, 0] = math.sqrt(1 / float(num_mel_bins))
    return torch.as_tensor(dct_matrix[:, :num_ceps], device=device).to(dtype)


def _get_lifter_coeffs(num_ceps: int, cepstral_lifter: float, dtype, device) -> torch.Tensor:
    i = np.arange(num_ceps, dtype=np.float64)
    return torch.as_tensor(1.0 + 0.5 * cepstral_lifter * np.sin(math.pi * i / cepstral_lifter),
                           device=device).to(dtype)


def mfcc(
    waveform: torch.Tensor,
    blackman_coeff: float = 0.42,
    cepstral_lifter: float = 22.0,
    channel: int = -1,
    dither: float = 0.0,
    energy_floor: float = 1.0,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    high_freq: float = 0.0,
    htk_compat: bool = False,
    low_freq: float = 20.0,
    num_ceps: int = 13,
    min_duration: float = 0.0,
    num_mel_bins: int = 23,
    preemphasis_coefficient: float = 0.97,
    raw_energy: bool = True,
    remove_dc_offset: bool = True,
    round_to_power_of_two: bool = True,
    sample_frequency: float = 16000.0,
    snip_edges: bool = True,
    subtract_mean: bool = False,
    use_energy: bool = False,
    vtln_high: float = -500.0,
    vtln_low: float = 100.0,
    vtln_warp: float = 1.0,
    window_type: str = POVEY,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Kaldi compute-mfcc-feats; returns (m, num_ceps)."""
    _check(num_ceps <= num_mel_bins,
           "num_ceps cannot be larger than num_mel_bins: %d vs %d" % (num_ceps, num_mel_bins))

    feature = fbank(
        waveform=waveform, blackman_coeff=blackman_coeff, channel=channel, dither=dither,
        energy_floor=energy_floor, frame_length=frame_length, frame_shift=frame_shift, high_freq=high_freq,
        htk_compat=htk_compat, low_freq=low_freq, min_duration=min_duration, num_mel_bins=num_mel_bins,
        preemphasis_coefficient=preemphasis_coefficient, raw_energy=raw_energy,
        remove_dc_offset=remove_dc_offset, round_to_power_of_two=round_to_power_of_two,
        sample_frequency=sample_frequency, snip_edges=snip_edges, subtract_mean=False,
        use_energy=use_energy, use_log_fbank=True, use_power=True, vtln_high=vtln_high,
        vtln_low=vtln_low, vtln_warp=vtln_warp, window_type=window_type, generator=generator,
    )

    if use_energy:
        signal_log_energy = feature[:, num_mel_bins if htk_compat else 0]
        mel_offset = int(not htk_compat)
        feature = feature[:, mel_offset : (num_mel_bins + mel_offset)]

    feature = exact_matmul(feature, _get_dct_matrix(num_ceps, num_mel_bins, feature.dtype, feature.device))

    if cepstral_lifter != 0.0:
        feature = feature * _get_lifter_coeffs(num_ceps, cepstral_lifter, feature.dtype, feature.device)[None, :]

    if use_energy:
        feature = torch.cat([signal_log_energy[:, None], feature[:, 1:]], dim=1)

    if htk_compat:
        energy = feature[:, 0:1]
        feature = feature[:, 1:]
        if not use_energy:
            energy = energy * math.sqrt(2)
        feature = torch.cat([feature, energy], dim=1)

    return _subtract_column_mean(feature, subtract_mean)
