"""Miscellaneous functional DSP ops, on the device of their input.

Same semantics as ``audio_tpu.functional._misc``: mu-law companding,
SpecAugment masks, delta coefficients, NCCF pitch detection, sliding-window
CMN, edit distance, BS.1770 loudness, pitch shift, convolution (direct and by
FFT), noise at an SNR, speed, pre- and de-emphasis, and the Frechet distance.

Where the JAX package materialises a gather that grows with the signal, the
port computes the same sums without it: ``detect_pitch_frequency`` forms the
NCCF's lagged frames one block of rows at a time, and ``loudness`` averages
its gating blocks over a window view.  ``convolve`` runs a depthwise
convolution with TF32 off in its forward and its backward, whatever the
caller's cuDNN flags (``utils.precision.exact_conv``).
``deemphasis`` runs through ``lfilter`` and ``loudness`` through its biquads,
so a CUDA float32 signal takes kernel K1 there.  The SpecAugment masks take a
``torch.Generator`` where the JAX package takes a key.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .._internal.windows import hann_window
from ..utils.precision import exact_conv
from ._filtering import highpass_biquad, lfilter, treble_biquad
from ._resample import resample
from ._spectral import phase_vocoder
from ._stft import istft as _istft
from ._stft import stft as _stft

__all__ = [
    "mu_law_encoding",
    "mu_law_decoding",
    "mask_along_axis",
    "mask_along_axis_iid",
    "compute_deltas",
    "detect_pitch_frequency",
    "sliding_window_cmn",
    "edit_distance",
    "loudness",
    "pitch_shift",
    "convolve",
    "fftconvolve",
    "add_noise",
    "speed",
    "preemphasis",
    "deemphasis",
    "frechet_distance",
]

# detect_pitch_frequency forms at most this many lagged-frame samples at once (512 MB in float32)
_NCCF_BLOCK_ELEMENTS = 1 << 27


def _half(dtype: torch.dtype) -> bool:
    return dtype in (torch.bfloat16, torch.float16)


def mu_law_encoding(x: torch.Tensor, quantization_channels: int) -> torch.Tensor:
    """Mu-law companding; expects [-1, 1] floats, returns int32 in [0, Q-1].

    The code is computed in float64, so that every device rounds a sample
    to the same code (a float32 ``log1p`` may differ by an ulp between
    devices, which moves a sample that lies on a code's edge).
    """
    mu = quantization_channels - 1.0
    x = x.to(torch.float64)
    x_mu = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)
    return ((x_mu + 1) / 2 * mu + 0.5).to(torch.int32)


def mu_law_decoding(x_mu: torch.Tensor, quantization_channels: int) -> torch.Tensor:
    mu = quantization_channels - 1.0
    if not x_mu.is_floating_point():
        x_mu = x_mu.to(torch.float32)
    x = (x_mu / mu) * 2 - 1.0
    return torch.sign(x) * (torch.exp(torch.abs(x) * math.log1p(mu)) - 1.0) / mu


def _get_mask_param(mask_param: int, p: float, axis_length: int) -> int:
    if p == 1.0:
        return mask_param
    return min(mask_param, int(axis_length * p))


def _check_mask_args(dim: int, min_dim: int, axis: int, p: float) -> None:
    if dim < min_dim:
        if min_dim == 2:
            raise ValueError(f"Spectrogram must have at least two dimensions (time and frequency) ({dim} given).")
        raise ValueError(f"Spectrogram must have at least three dimensions ({dim} given).")
    if axis not in (dim - 2, dim - 1):
        raise ValueError(f"Only Frequency and Time masking are supported ({dim - 2}, {dim - 1} supported; {axis} given).")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"The value of p must be between 0.0 and 1.0 ({p} given).")


def _mask_draws(shape, generator: Optional[torch.Generator], device: torch.device):
    """Two float32 uniform draws of ``shape`` from ``generator`` on its device (``None``: a generator
    on ``device`` seeded 0), moved to ``device``: the span's length, then its start."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    u = [torch.rand(shape, generator=generator, device=generator.device) for _ in range(2)]
    return u[0].to(device), u[1].to(device)


def _span_mask(u_value, u_min, mask_param: int, size: int, axis_shape, device) -> torch.Tensor:
    value = u_value * mask_param
    min_value = u_min * (size - value)
    start = min_value.to(torch.int32)
    end = start + value.to(torch.int32)
    arange = torch.arange(size, device=device).reshape(axis_shape)
    return (arange >= start) & (arange < end)


def mask_along_axis(
    specgram: torch.Tensor,
    mask_param: int,
    mask_value: float,
    axis: int,
    p: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Mask a random span [v0, v0+v) along ``axis``; same span for all examples.

    The span comes from two uniform draws of ``generator`` (``None``: a
    generator on the spectrogram's device seeded 0); nothing is read back.
    """
    dim = specgram.dim()
    _check_mask_args(dim, 2, axis, p)
    mask_param = _get_mask_param(mask_param, p, specgram.shape[axis])
    if mask_param < 1:
        return specgram
    size = specgram.shape[axis]
    shape = [1] * dim
    shape[axis] = size
    u_value, u_min = _mask_draws((), generator, specgram.device)
    mask = _span_mask(u_value, u_min, mask_param, size, shape, specgram.device)
    fill = torch.as_tensor(mask_value, dtype=specgram.dtype, device=specgram.device)
    return torch.where(mask, fill, specgram)


def mask_along_axis_iid(
    specgrams: torch.Tensor,
    mask_param: int,
    mask_value: Union[float, torch.Tensor],
    axis: int,
    p: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Mask independent random spans per (batch, channel) along ``axis``.

    Each leading index draws its span's length, then its start, from
    ``generator`` (``None``: a generator on the spectrograms' device seeded 0).
    """
    dim = specgrams.dim()
    _check_mask_args(dim, 3, axis, p)
    mask_param = _get_mask_param(mask_param, p, specgrams.shape[axis])
    if mask_param < 1:
        return specgrams
    lead_shape = specgrams.shape[: dim - 2]
    size = specgrams.shape[axis]
    shape = [1] * dim
    shape[axis] = size
    u_value, u_min = _mask_draws(lead_shape, generator, specgrams.device)
    mask = _span_mask(u_value[..., None, None], u_min[..., None, None], mask_param, size, shape, specgrams.device)
    fill = torch.as_tensor(mask_value, dtype=specgrams.dtype, device=specgrams.device)
    return torch.where(mask, fill, specgrams)


def compute_deltas(specgram: torch.Tensor, win_length: int = 5, mode: str = "replicate") -> torch.Tensor:
    """Delta coefficients along the last axis; (..., freq, time) -> same shape."""
    if win_length < 3:
        raise ValueError(f"Window length should be greater than or equal to 3. Found win_length {win_length}")
    n = (win_length - 1) // 2
    denom = n * (n + 1) * (2 * n + 1) / 3
    if mode not in ("replicate", "constant", "reflect"):
        raise KeyError(mode)
    shape = specgram.shape
    length = shape[-1]
    padded = F.pad(specgram.reshape(-1, 1, length), (n, n), mode=mode)[:, 0]
    # correlation with [-n..n]: out[t] = sum_k k * x[t+k], one shifted slice a tap
    out = None
    for w in range(2 * n + 1):
        if w == n:
            continue
        term = padded[:, w : w + length] * (w - n)
        out = term if out is None else out + term
    return (out / denom).reshape(shape)


def _compute_nccf(waveform: torch.Tensor, sample_rate: int, frame_time: float, freq_low: int) -> torch.Tensor:
    """NCCF (rows, frames, lags) of (rows, time), the JAX package's sums; the lagged frames
    (rows, frames, lags, frame size) are formed for a block of rows at a time."""
    eps = 1e-9
    lags = int(math.ceil(sample_rate / freq_low))
    frame_size = int(math.ceil(sample_rate * frame_time))
    waveform_length = waveform.shape[-1]
    num_of_frames = int(math.ceil(waveform_length / frame_size))
    p = lags + num_of_frames * frame_size - waveform_length
    waveform = F.pad(waveform, (0, p))

    # s1[f, i] = w[f*frame_size + i], s2[f, lag, i] = w[lag + f*frame_size + i]
    windows = waveform.unfold(-1, frame_size, 1)  # (rows, starts, frame_size), a view
    base = torch.arange(num_of_frames, device=waveform.device) * frame_size
    lag_starts = base[:, None] + torch.arange(1, lags + 1, device=waveform.device)[None, :]  # (F, lags)
    s1 = windows[:, base]  # (rows, F, N)
    e1 = eps + torch.linalg.vector_norm(s1, dim=-1)  # (rows, F)
    rows = waveform.shape[0]
    block = max(1, _NCCF_BLOCK_ELEMENTS // (num_of_frames * lags * frame_size))
    out = torch.empty((rows, num_of_frames, lags), dtype=waveform.dtype, device=waveform.device)
    for r0 in range(0, rows, block):
        s2 = windows[r0 : r0 + block, lag_starts]  # (block, F, lags, N)
        num = (s2 * s1[r0 : r0 + block, :, None, :]).sum(-1)
        e2 = eps + torch.linalg.vector_norm(s2, dim=-1)  # (block, F, lags)
        out[r0 : r0 + block] = num / (e1[r0 : r0 + block, :, None] ** 2) / e2**2
    return out


def _combine_max(a, b, thresh: float = 0.99):
    mask = a[0] > thresh * b[0]
    values = torch.where(mask, a[0], b[0])
    indices = torch.where(mask, a[1], b[1])
    return values, indices


def _find_max_per_frame(nccf: torch.Tensor, sample_rate: int, freq_high: int) -> torch.Tensor:
    lag_min = int(math.ceil(sample_rate / freq_high))
    best = torch.max(nccf[..., lag_min:], -1)  # the first index of the maximum
    half_size = nccf.shape[-1] // 2
    half = torch.max(nccf[..., lag_min:half_size], -1)
    _, indices = _combine_max(half, best)
    return indices + lag_min + 1


def _median_smoothing(indices: torch.Tensor, win_length: int) -> torch.Tensor:
    pad_length = (win_length - 1) // 2
    edge = indices[..., :1].expand(indices.shape[:-1] + (pad_length,))
    roll = torch.cat([edge, indices], dim=-1).unfold(-1, win_length, 1)
    # the lower of the two middle values for even windows, as torch.median
    return torch.sort(roll, dim=-1).values[..., (win_length - 1) // 2]


def detect_pitch_frequency(
    waveform: torch.Tensor,
    sample_rate: int,
    frame_time: float = 1e-2,
    win_length: int = 30,
    freq_low: int = 85,
    freq_high: int = 3400,
) -> torch.Tensor:
    """Pitch frequency per frame via NCCF + median smoothing; (..., frame)."""
    shape = waveform.shape
    waveform = waveform.reshape((-1, shape[-1]))
    nccf = _compute_nccf(waveform, sample_rate, frame_time, freq_low)
    indices = _find_max_per_frame(nccf, sample_rate, freq_high)
    indices = _median_smoothing(indices, win_length)
    lag = 1e-9 + indices.to(torch.float32)
    # a true division: torch computes a Python number over a tensor as the number times the reciprocal
    freq = torch.full_like(lag, sample_rate) / lag
    return freq.reshape(shape[:-1] + freq.shape[-1:])


def sliding_window_cmn(
    specgram: torch.Tensor,
    cmn_window: int = 600,
    min_cmn_window: int = 100,
    center: bool = False,
    norm_vars: bool = False,
) -> torch.Tensor:
    """Sliding-window cepstral mean (and variance) normalization, (..., time, freq).

    The JAX package's closed form: window bounds computed on the host (moved to
    the device once a call), then two cumulative sums and their differences.
    """
    input_shape = specgram.shape
    num_frames, num_feats = input_shape[-2:]
    x = specgram.reshape((-1, num_frames, num_feats))

    t = np.arange(num_frames)
    if center:
        s = t - cmn_window // 2
        e = s + cmn_window
    else:
        s = t - cmn_window
        e = t + 1
    e = np.where(s < 0, e - s, e)
    s = np.maximum(s, 0)
    if not center:
        e = np.where(e > t, np.maximum(t + 1, min_cmn_window), e)
    over = e > num_frames
    s = np.where(over, np.maximum(s - (e - num_frames), 0), s)
    e = np.where(over, num_frames, e)
    window_frames = (e - s).astype(np.float64)
    s, e = (torch.as_tensor(v, device=x.device) for v in (s, e))

    def window_sums(v):
        csum = F.pad(torch.cumsum(v, dim=1), (0, 0, 1, 0))  # (B, T+1, F)
        return csum[:, e] - csum[:, s]

    cur_sum = window_sums(x)
    wf = torch.as_tensor(window_frames, dtype=x.dtype, device=x.device)[None, :, None]
    out = x - cur_sum / wf
    if norm_vars:
        cur_sumsq = window_sums(x * x)
        variance = cur_sumsq / wf - (cur_sum**2) / (wf**2)
        out = out * torch.rsqrt(variance)
        out = torch.where(wf == 1, torch.zeros_like(out), out)
    return out.reshape(input_shape)


def edit_distance(seq1: Sequence, seq2: Sequence) -> int:
    """Levenshtein distance between two host-side sequences."""
    len_sent2 = len(seq2)
    dold = list(range(len_sent2 + 1))
    dnew = [0 for _ in range(len_sent2 + 1)]
    for i in range(1, len(seq1) + 1):
        dnew[0] = i
        for j in range(1, len_sent2 + 1):
            if seq1[i - 1] == seq2[j - 1]:
                dnew[j] = dold[j - 1]
            else:
                dnew[j] = min(dold[j - 1] + 1, dnew[j - 1] + 1, dold[j] + 1)
        dnew, dold = dold, dnew
    return int(dold[-1])


def loudness(waveform: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """ITU-R BS.1770-4 loudness (LKFS) with K-weighting and two-stage gating.

    The 38 Hz K-weighting highpass has a pole near 1, so half precision
    measures in float32 and casts the result back, as the JAX package.
    """
    if waveform.shape[-2] > 5:
        raise ValueError("Only up to 5 channels are supported.")
    if _half(waveform.dtype):
        return loudness(waveform.float(), sample_rate).to(waveform.dtype)
    gate_duration = 0.4
    overlap = 0.75
    gamma_abs = -70.0
    kweight_bias = -0.691
    gate_samples = int(round(gate_duration * sample_rate))
    step = int(round(gate_samples * (1 - overlap)))

    waveform = treble_biquad(waveform, sample_rate, 4.0, 1500.0, 1 / math.sqrt(2))
    waveform = highpass_biquad(waveform, sample_rate, 38.0, 0.5)

    energy = torch.square(waveform).unfold(-1, gate_samples, step).mean(-1)  # (..., ch, blocks)

    g = torch.tensor([1.0, 1.0, 1.0, 1.41, 1.41], dtype=waveform.dtype, device=waveform.device)[: energy.shape[-2]]
    energy_weighted = torch.sum(g[..., None] * energy, dim=-2)
    block_loudness = kweight_bias + 10 * torch.log10(energy_weighted)

    def gated_energy(gated):
        filtered = torch.sum(gated * energy, dim=-1) / torch.clamp(torch.sum(gated, dim=-1), min=1)
        return torch.sum(g * filtered, dim=-1)

    gated = (block_loudness > gamma_abs)[..., None, :]
    gamma_rel = kweight_bias + 10 * torch.log10(gated_energy(gated)) - 10
    gated = (gated[..., 0, :] & (block_loudness > gamma_rel[..., None]))[..., None, :]
    return kweight_bias + 10 * torch.log10(gated_energy(gated))


def _stretch_waveform(
    waveform: torch.Tensor,
    n_steps: int,
    bins_per_octave: int = 12,
    n_fft: int = 512,
    win_length: Optional[int] = None,
    hop_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    if window is None:
        window = hann_window(win_length, dtype=waveform.dtype, device=waveform.device)
    shape = waveform.shape
    waveform = waveform.reshape((-1, shape[-1]))
    ori_len = shape[-1]
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    spec_f = _stft(
        waveform, n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window,
        center=True, pad_mode="reflect", normalized=False, onesided=True,
    )
    phase_advance = torch.linspace(0, math.pi * hop_length, spec_f.shape[-2], dtype=waveform.dtype,
                                   device=waveform.device)[..., None]
    spec_stretch = phase_vocoder(spec_f, rate, phase_advance)
    len_stretch = int(round(ori_len / rate))
    return _istft(
        spec_stretch, n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window, length=len_stretch
    )


def pitch_shift(
    waveform: torch.Tensor,
    sample_rate: int,
    n_steps: int,
    bins_per_octave: int = 12,
    n_fft: int = 512,
    win_length: Optional[int] = None,
    hop_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Shift pitch by n_steps (phase vocoder stretch + resample).

    Half-precision inputs compute in f32 (there is no complex half type for
    the STFT core) and cast back on return.  The resampling kernel is built on
    the host for ``gcd(int(sample_rate / rate), sample_rate)``, as the JAX
    package builds it.
    """
    shape = waveform.shape
    if _half(waveform.dtype):
        out = pitch_shift(waveform.float(), sample_rate, n_steps, bins_per_octave, n_fft, win_length,
                          hop_length, None if window is None else window.float())
        return out.to(waveform.dtype)
    stretched = _stretch_waveform(waveform, n_steps, bins_per_octave, n_fft, win_length, hop_length, window)
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    shifted = resample(stretched, int(sample_rate / rate), sample_rate)
    ori_len = shape[-1]
    shift_len = shifted.shape[-1]
    if shift_len > ori_len:
        shifted = shifted[..., :ori_len]
    else:
        shifted = F.pad(shifted, (0, ori_len - shift_len))
    return shifted.reshape(shape[:-1] + (ori_len,))


def _check_shape_compatible(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != y.dim():
        raise ValueError(f"The operands must be the same dimension (got {x.dim()} and {y.dim()}).")
    for xi, yi in zip(x.shape[:-1], y.shape[:-1]):
        if xi != yi and xi != 1 and yi != 1:
            raise ValueError(f"Leading dimensions of x and y are not broadcastable (got {x.shape} and {y.shape}).")


def _apply_convolve_mode(conv_result: torch.Tensor, x_length: int, y_length: int, mode: str) -> torch.Tensor:
    if mode == "full":
        return conv_result
    if mode == "valid":
        target_length = max(x_length, y_length) - min(x_length, y_length) + 1
        start_idx = (conv_result.shape[-1] - target_length) // 2
        return conv_result[..., start_idx : start_idx + target_length]
    if mode == "same":
        start_idx = (conv_result.shape[-1] - x_length) // 2
        return conv_result[..., start_idx : start_idx + x_length]
    raise ValueError(f"Unrecognized mode value '{mode}'. Please specify one of ['full', 'valid', 'same'].")


def fftconvolve(x: torch.Tensor, y: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """True convolution along the last axis via rfft.

    Half types compute in f32 and cast back (the FFT takes f32 and f64).
    """
    _check_shape_compatible(x, y)
    out_dtype = torch.promote_types(x.dtype, y.dtype)
    if _half(out_dtype):
        x, y = x.float(), y.float()
    n = x.shape[-1] + y.shape[-1] - 1
    fresult = torch.fft.rfft(x, n=n) * torch.fft.rfft(y, n=n)
    result = torch.fft.irfft(fresult, n=n).to(out_dtype)
    return _apply_convolve_mode(result, x.shape[-1], y.shape[-1], mode)


def convolve(x: torch.Tensor, y: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """True convolution along the last axis via the direct method: a depthwise convolution,
    one group a row, with TF32 off in its forward and its backward (``exact_conv``)."""
    _check_shape_compatible(x, y)
    x_size, y_size = x.shape[-1], y.shape[-1]
    if x.shape[-1] < y.shape[-1]:
        x, y = y, x
    if x.shape[:-1] != y.shape[:-1]:
        new_shape = tuple(max(i, j) for i, j in zip(x.shape[:-1], y.shape[:-1]))
        x = x.expand(new_shape + (x.shape[-1],))
        y = y.expand(new_shape + (y.shape[-1],))
    num = math.prod(x.shape[:-1])
    rx = x.reshape((1, num, x.shape[-1]))  # (N=1, C=num, W) depthwise
    ry = torch.flip(y.reshape((num, 1, y.shape[-1])), (-1,))  # (O=num, I=1, K)
    out = exact_conv(rx, ry, padding=y.shape[-1] - 1, groups=num)
    result = out.reshape(x.shape[:-1] + (out.shape[-1],))
    return _apply_convolve_mode(result, x_size, y_size, mode)


def add_noise(
    waveform: torch.Tensor,
    noise: torch.Tensor,
    snr: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scale and add noise to waveform per SNR (dB)."""
    if not (waveform.dim() - 1 == noise.dim() - 1 == snr.dim() and (lengths is None or lengths.dim() == snr.dim())):
        raise ValueError("Input leading dimensions don't match.")
    length = waveform.shape[-1]
    if length != noise.shape[-1]:
        raise ValueError(f"Length dimensions of waveform and noise don't match (got {length} and {noise.shape[-1]}).")
    if lengths is not None:
        mask = torch.arange(length, device=waveform.device) < lengths[..., None]
        masked_waveform = waveform * mask
        masked_noise = noise * mask
    else:
        masked_waveform = waveform
        masked_noise = noise
    energy_signal = torch.sum(masked_waveform**2, dim=-1)
    energy_noise = torch.sum(masked_noise**2, dim=-1)
    original_snr_db = 10 * (torch.log10(energy_signal) - torch.log10(energy_noise))
    scale = 10 ** ((original_snr_db - snr) / 20.0)
    return waveform + scale[..., None] * noise


def speed(
    waveform: torch.Tensor,
    orig_freq: int,
    factor: float,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Adjust waveform speed by ``factor`` via resampling.

    Integer ``lengths`` scale by an exact integer ceiling division.
    """
    source_sample_rate, target_sample_rate = _speed_rates(orig_freq, factor)
    out_lengths = _speed_lengths(lengths, source_sample_rate, target_sample_rate)
    return resample(waveform, source_sample_rate, target_sample_rate), out_lengths


def _speed_rates(orig_freq: int, factor: float) -> Tuple[int, int]:
    """The source and target rates of a speed change, divided by their greatest common divisor."""
    source_sample_rate = int(factor * orig_freq)
    target_sample_rate = int(orig_freq)
    gcd = math.gcd(source_sample_rate, target_sample_rate)
    return source_sample_rate // gcd, target_sample_rate // gcd


def _speed_lengths(lengths: Optional[torch.Tensor], source_sample_rate: int,
                   target_sample_rate: int) -> Optional[torch.Tensor]:
    if lengths is None:
        return None
    if lengths.is_floating_point():
        return torch.ceil(lengths * target_sample_rate / source_sample_rate).to(lengths.dtype)
    return -((-lengths * target_sample_rate) // source_sample_rate)


def preemphasis(waveform: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """y[i] = x[i] - coeff * x[i-1]."""
    shifted = F.pad(waveform, (1, 0))[..., :-1]
    return waveform - coeff * shifted


def deemphasis(waveform: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """y[i] = x[i] + coeff * y[i-1] (inverse of preemphasis), through ``lfilter``."""
    a = torch.tensor([1.0, -coeff], dtype=waveform.dtype, device=waveform.device)
    b = torch.tensor([1.0, 0.0], dtype=waveform.dtype, device=waveform.device)
    return lfilter(waveform, a_coeffs=a, b_coeffs=b)


def frechet_distance(mu_x, sigma_x, mu_y, sigma_y):
    """Frechet distance between two multivariate normals.

    Half-precision inputs compute in f32 (no eigensolver takes half types)
    and cast back.  Tr(sqrt(Sx Sy)) comes from the eigenvalues of Sx Sy on
    the inputs' device, cast to complex64 before the square root as the JAX
    package casts them, so float64 inputs also end at float32 precision there.
    """
    if mu_x.dim() != 1:
        raise ValueError(f"Input mu_x must be one-dimensional; got dimension {mu_x.dim()}.")
    if sigma_x.dim() != 2:
        raise ValueError(f"Input sigma_x must be two-dimensional; got dimension {sigma_x.dim()}.")
    if _half(mu_x.dtype):
        out = frechet_distance(mu_x.float(), sigma_x.float(), mu_y.float(), sigma_y.float())
        return out.to(mu_x.dtype)
    a = torch.sum((mu_x - mu_y) ** 2)
    b = torch.trace(sigma_x) + torch.trace(sigma_y)
    eigs = torch.linalg.eigvals(sigma_x @ sigma_y)
    c = torch.sum(torch.real(torch.sqrt(eigs.to(torch.complex64))))
    return a + b - 2 * c
