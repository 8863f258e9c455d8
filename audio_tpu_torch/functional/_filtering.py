"""Sox-style filtering: lfilter, filtfilt, the biquad designs and the effects.

Same semantics as ``audio_tpu.functional._filtering``: coefficients are
normalized by ``a[0]``, the FIR stage runs before the all-pole recurrence,
and the output is clamped to [-1, 1] by default.  On CUDA, inside the kernels'
limits (float32, at most 129 taps), a signal longer than 256 samples runs the
fused kernel K1 and, under autograd, kernel K4 in its backward; a shorter one
runs the plain FIR stage and kernel K4, the split the JAX package makes at
that length.  Outside those limits a CUDA signal runs the plain FIR stage and
recurrence in its own dtype, differentiated by autograd, as the JAX package
runs ``iir_apply(_fir_causal(...))`` there.  On the CPU ``lfilter`` runs the
plain FIR stage and recurrence, K1's plain version, with the same analytic
backward.

The sox effects follow the JAX package's arithmetic in the same order.
``overdrive``'s one-pole smoothing runs through ``iir_apply`` (kernel K4 for
a CUDA float32 tensor; the plain recurrence on the tensor's device for its
other dtypes, which K4 does not take).  ``phaser`` and ``flanger`` are delay
lines with feedback: their read and write positions are computed on the host
with numpy before the loop, which then runs over time in PyTorch, vectorised
over every row, and reads nothing back from the device.  ``flanger`` without
feedback (``regen`` 0) needs no loop: each output is an interpolated read of
the input's past, gathered at once.  ``dither`` takes a ``torch.Generator``
where the JAX package takes a key.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._internal.windows import bartlett_window
from ..ops.cuda_iir import MAX_TAPS, iir_apply, lfilter_fused
from ..ops.iir import fir_causal, iir_plain

__all__ = [
    "allpass_biquad",
    "band_biquad",
    "bandpass_biquad",
    "bandreject_biquad",
    "bass_biquad",
    "biquad",
    "contrast",
    "dcshift",
    "deemph_biquad",
    "dither",
    "equalizer_biquad",
    "filtfilt",
    "flanger",
    "gain",
    "highpass_biquad",
    "lfilter",
    "lowpass_biquad",
    "overdrive",
    "phaser",
    "riaa_biquad",
    "treble_biquad",
]

# Shortest signal that takes the fused path (the JAX gate).
_FUSED_MIN_T = 257


def _filter_route(on_cuda: bool, dtype: torch.dtype, t: int, taps: int) -> str:
    """How ``lfilter`` runs a signal of ``t`` samples through ``taps`` coefficients a row.

    On CUDA: ``"plain"`` outside the kernels' limits (a dtype other than float32, or more than
    ``MAX_TAPS`` taps): the plain FIR stage and recurrence, under autograd; ``"short"`` below the
    fused kernel's length or with no poles: the plain FIR stage and kernel K4; ``"fused"``
    otherwise: kernel K1, and K4 in its backward.  On the CPU always ``"fused"``: K1's plain
    version with the analytic backward.
    """
    if on_cuda and (dtype != torch.float32 or taps > MAX_TAPS):
        return "plain"
    if on_cuda and (t < _FUSED_MIN_T or taps < 2):
        return "short"
    return "fused"


def lfilter(
    waveform: torch.Tensor,
    a_coeffs,
    b_coeffs,
    clamp: bool = True,
    batching: bool = True,
) -> torch.Tensor:
    """IIR filter by difference equation; torchaudio lfilter semantics.

    Coefficients may be 1D ``(order+1,)`` or 2D ``(num_filters, order+1)``.
    """
    a_coeffs = torch.as_tensor(a_coeffs, dtype=waveform.dtype, device=waveform.device)
    b_coeffs = torch.as_tensor(b_coeffs, dtype=waveform.dtype, device=waveform.device)
    if a_coeffs.shape != b_coeffs.shape:
        raise ValueError(
            f"Expected coeffs to be the same size. Found: a_coeffs {tuple(a_coeffs.shape)}, "
            f"b_coeffs {tuple(b_coeffs.shape)}"
        )
    if a_coeffs.dim() > 2:
        raise ValueError(f"Expected coeffs to have at most 2 dimensions. Found: {a_coeffs.dim()}")

    if a_coeffs.dim() > 1:
        if batching:
            if waveform.dim() < 2 or waveform.shape[-2] != a_coeffs.shape[0]:
                raise ValueError(
                    "Expected number of batches in waveform and coeffs to be the same."
                    f" Found: coeffs batches: {a_coeffs.shape[0]}, waveform shape: {tuple(waveform.shape)}"
                )
        else:
            waveform = torch.stack([waveform] * a_coeffs.shape[0], -2)
    else:
        a_coeffs = a_coeffs[None]
        b_coeffs = b_coeffs[None]

    shape = waveform.shape
    x = waveform.reshape(-1, a_coeffs.shape[0], shape[-1])

    a0 = a_coeffs[:, 0:1]
    a_norm = (a_coeffs / a0).contiguous()
    b_norm = (b_coeffs / a0).contiguous()

    route = _filter_route(x.is_cuda, x.dtype, x.shape[-1], a_norm.shape[-1])
    if route == "plain":
        output = iir_plain(fir_causal(x, b_norm), a_norm[:, 1:])
    elif route == "short":
        output = iir_apply(fir_causal(x, b_norm).contiguous(), a_norm)
    else:
        output = lfilter_fused(x.contiguous(), a_norm, b_norm)

    if clamp:
        output = torch.clamp(output, -1.0, 1.0)
    return output.reshape(shape[:-1] + (output.shape[-1],))


def filtfilt(waveform: torch.Tensor, a_coeffs, b_coeffs, clamp: bool = True) -> torch.Tensor:
    """Apply an IIR filter forward and backward (zero-phase)."""
    forward_filtered = lfilter(waveform, a_coeffs, b_coeffs, clamp=False, batching=True)
    backward = lfilter(torch.flip(forward_filtered, (-1,)), a_coeffs, b_coeffs, clamp=clamp, batching=True)
    return torch.flip(backward, (-1,))


# ---------------------------------------------------------------------------
# Biquad designs (RBJ audio-EQ-cookbook / SoX formulas)
# ---------------------------------------------------------------------------


def _scalar(v, waveform: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=waveform.dtype, device=waveform.device).reshape(())


def biquad(waveform, b0, b1, b2, a0, a1, a2) -> torch.Tensor:
    """Second-order section with zero initial conditions."""
    coeffs = [_scalar(v, waveform) for v in (b0, b1, b2, a0, a1, a2)]
    b = torch.stack(coeffs[:3])
    a = torch.stack(coeffs[3:])
    return lfilter(waveform, a, b)


def _w0(freq, waveform, sample_rate: int) -> torch.Tensor:
    return 2 * math.pi * _scalar(freq, waveform) / sample_rate


def allpass_biquad(waveform, sample_rate: int, central_freq, Q=0.707) -> torch.Tensor:
    w0 = _w0(central_freq, waveform, sample_rate)
    alpha = torch.sin(w0) / 2 / Q
    b0 = 1 - alpha
    b1 = -2 * torch.cos(w0)
    b2 = 1 + alpha
    return biquad(waveform, b0, b1, b2, 1 + alpha, b1, 1 - alpha)


def band_biquad(waveform, sample_rate: int, central_freq, Q=0.707, noise: bool = False) -> torch.Tensor:
    central_freq = _scalar(central_freq, waveform)
    w0 = 2 * math.pi * central_freq / sample_rate
    bw_hz = central_freq / Q
    a2 = torch.exp(-2 * math.pi * bw_hz / sample_rate)
    a1 = -4 * a2 / (1 + a2) * torch.cos(w0)
    b0 = torch.sqrt(1 - a1 * a1 / (4 * a2)) * (1 - a2)
    if noise:
        mult = torch.sqrt(((1 + a2) * (1 + a2) - a1 * a1) * (1 - a2) / (1 + a2)) / b0
        b0 = mult * b0
    return biquad(waveform, b0, 0.0, 0.0, 1.0, a1, a2)


def bandpass_biquad(waveform, sample_rate: int, central_freq, Q=0.707,
                    const_skirt_gain: bool = False) -> torch.Tensor:
    w0 = _w0(central_freq, waveform, sample_rate)
    alpha = torch.sin(w0) / 2 / Q
    temp = torch.sin(w0) / 2 if const_skirt_gain else alpha
    return biquad(waveform, temp, 0.0, -temp, 1 + alpha, -2 * torch.cos(w0), 1 - alpha)


def bandreject_biquad(waveform, sample_rate: int, central_freq, Q=0.707) -> torch.Tensor:
    w0 = _w0(central_freq, waveform, sample_rate)
    alpha = torch.sin(w0) / 2 / Q
    b1 = -2 * torch.cos(w0)
    return biquad(waveform, 1.0, b1, 1.0, 1 + alpha, b1, 1 - alpha)


def _shelf_coeffs(w0, alpha, A, bass: bool):
    temp1 = 2 * torch.sqrt(A) * alpha
    temp2 = (A - 1) * torch.cos(w0)
    temp3 = (A + 1) * torch.cos(w0)
    if bass:
        b0 = A * ((A + 1) - temp2 + temp1)
        b1 = 2 * A * ((A - 1) - temp3)
        b2 = A * ((A + 1) - temp2 - temp1)
        a0 = (A + 1) + temp2 + temp1
        a1 = -2 * ((A - 1) + temp3)
        a2 = (A + 1) + temp2 - temp1
    else:
        b0 = A * ((A + 1) + temp2 + temp1)
        b1 = -2 * A * ((A - 1) + temp3)
        b2 = A * ((A + 1) + temp2 - temp1)
        a0 = (A + 1) - temp2 + temp1
        a1 = 2 * ((A - 1) - temp3)
        a2 = (A + 1) - temp2 - temp1
    return b0, b1, b2, a0, a1, a2


def bass_biquad(waveform, sample_rate: int, gain, central_freq=100, Q=0.707) -> torch.Tensor:
    w0 = _w0(central_freq, waveform, sample_rate)
    alpha = torch.sin(w0) / 2 / Q
    A = torch.exp(_scalar(gain, waveform) / 40 * math.log(10))
    b0, b1, b2, a0, a1, a2 = _shelf_coeffs(w0, alpha, A, bass=True)
    return biquad(waveform, b0 / a0, b1 / a0, b2 / a0, 1.0, a1 / a0, a2 / a0)


def treble_biquad(waveform, sample_rate: int, gain, central_freq=3000, Q=0.707) -> torch.Tensor:
    w0 = _w0(central_freq, waveform, sample_rate)
    alpha = torch.sin(w0) / 2 / Q
    A = torch.exp(_scalar(gain, waveform) / 40 * math.log(10))
    b0, b1, b2, a0, a1, a2 = _shelf_coeffs(w0, alpha, A, bass=False)
    return biquad(waveform, b0, b1, b2, a0, a1, a2)


def deemph_biquad(waveform, sample_rate: int) -> torch.Tensor:
    """ISO 908 CD de-emphasis shelving filter (44.1k / 48k only).

    Half precision computes in float32 and casts back (see ``riaa_biquad``).
    """
    if waveform.dtype in (torch.bfloat16, torch.float16):
        return deemph_biquad(waveform.float(), sample_rate).to(waveform.dtype)
    if sample_rate == 44100:
        central_freq, width_slope, gain_db = 5283, 0.4845, -9.477
    elif sample_rate == 48000:
        central_freq, width_slope, gain_db = 5356, 0.479, -9.62
    else:
        raise ValueError("Sample rate must be 44100 (audio-CD) or 48000 (DAT)")
    w0 = 2 * math.pi * central_freq / sample_rate
    A = math.exp(gain_db / 40.0 * math.log(10))
    alpha = math.sin(w0) / 2 * math.sqrt((A + 1 / A) * (1 / width_slope - 1) + 2)
    # the design runs on float64 host scalars; biquad casts the coefficients
    w0, alpha, A = (torch.tensor(v, dtype=torch.float64) for v in (w0, alpha, A))
    b0, b1, b2, a0, a1, a2 = _shelf_coeffs(w0, alpha, A, bass=False)
    return biquad(waveform, b0, b1, b2, a0, a1, a2)


def equalizer_biquad(waveform, sample_rate: int, center_freq, gain, Q=0.707) -> torch.Tensor:
    w0 = _w0(center_freq, waveform, sample_rate)
    A = torch.exp(_scalar(gain, waveform) / 40.0 * math.log(10))
    alpha = torch.sin(w0) / 2 / Q
    return biquad(
        waveform, 1 + alpha * A, -2 * torch.cos(w0), 1 - alpha * A, 1 + alpha / A, -2 * torch.cos(w0), 1 - alpha / A
    )


def highpass_biquad(waveform, sample_rate: int, cutoff_freq, Q=0.707) -> torch.Tensor:
    w0 = _w0(cutoff_freq, waveform, sample_rate)
    alpha = torch.sin(w0) / 2.0 / Q
    b0 = (1 + torch.cos(w0)) / 2
    b1 = -1 - torch.cos(w0)
    return biquad(waveform, b0, b1, b0, 1 + alpha, -2 * torch.cos(w0), 1 - alpha)


def lowpass_biquad(waveform, sample_rate: int, cutoff_freq, Q=0.707) -> torch.Tensor:
    w0 = _w0(cutoff_freq, waveform, sample_rate)
    alpha = torch.sin(w0) / 2 / Q
    b0 = (1 - torch.cos(w0)) / 2
    b1 = 1 - torch.cos(w0)
    return biquad(waveform, b0, b1, b0, 1 + alpha, -2 * torch.cos(w0), 1 - alpha)


def riaa_biquad(waveform, sample_rate: int) -> torch.Tensor:
    """RIAA vinyl playback equalization.

    The low-frequency pole sits at |p| > 0.992, so half precision computes in
    float32 and casts back.
    """
    if waveform.dtype in (torch.bfloat16, torch.float16):
        return riaa_biquad(waveform.float(), sample_rate).to(waveform.dtype)
    if sample_rate == 44100:
        zeros = [-0.2014898, 0.9233820]
        poles = [0.7083149, 0.9924091]
    elif sample_rate == 48000:
        zeros = [-0.1766069, 0.9321590]
        poles = [0.7396325, 0.9931330]
    elif sample_rate == 88200:
        zeros = [-0.1168735, 0.9648312]
        poles = [0.8590646, 0.9964002]
    elif sample_rate == 96000:
        zeros = [-0.1141486, 0.9676817]
        poles = [0.8699137, 0.9966946]
    else:
        raise ValueError("Sample rate must be 44.1k, 48k, 88.2k, or 96k")
    b0, b1, b2 = 1.0, -(zeros[0] + zeros[1]), zeros[0] * zeros[1]
    a0, a1, a2 = 1.0, -(poles[0] + poles[1]), poles[0] * poles[1]
    # normalize to 0 dB at 1 kHz
    y = 2 * math.pi * 1000 / sample_rate
    b_re = b0 + b1 * math.cos(-y) + b2 * math.cos(-2 * y)
    a_re = a0 + a1 * math.cos(-y) + a2 * math.cos(-2 * y)
    b_im = b1 * math.sin(-y) + b2 * math.sin(-2 * y)
    a_im = a1 * math.sin(-y) + a2 * math.sin(-2 * y)
    g = 1 / math.sqrt((b_re**2 + b_im**2) / (a_re**2 + a_im**2))
    return biquad(waveform, b0 * g, b1 * g, b2 * g, a0, a1, a2)


# ---------------------------------------------------------------------------
# Effects
# ---------------------------------------------------------------------------


def _db2linear(x: float) -> float:
    return math.exp(x * math.log(10) / 20.0)


def _host_table(a, device: torch.device) -> torch.Tensor:
    """A table computed on the host (numpy or a CPU tensor) on ``device``; a CUDA copy goes
    through pinned memory without a synchronisation, so an effect's set-up reads nothing back."""
    t = (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))).contiguous()
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def contrast(waveform: torch.Tensor, enhancement_amount: float = 75.0) -> torch.Tensor:
    """SoX contrast effect (waveshaping compression)."""
    if not 0 <= enhancement_amount <= 100:
        raise ValueError("Allowed range of values for enhancement_amount : 0-100")
    contrast_val = enhancement_amount / 750.0
    temp1 = waveform * (math.pi / 2)
    temp2 = contrast_val * torch.sin(temp1 * 4)
    return torch.sin(temp1 + temp2)


def dcshift(waveform: torch.Tensor, shift: float, limiter_gain: Optional[float] = None) -> torch.Tensor:
    """DC shift with optional peak limiter."""
    if limiter_gain is not None:
        limiter_threshold = 1.0 - (abs(shift) - limiter_gain)
    if limiter_gain is not None and shift > 0:
        mask = waveform > limiter_threshold
        temp = (waveform - limiter_threshold) * limiter_gain / (1 - limiter_threshold)
        peaked = torch.clamp(temp + limiter_threshold + shift, max=limiter_threshold)
        return torch.where(mask, peaked, torch.clamp(waveform + shift, -1, 1))
    if limiter_gain is not None and shift < 0:
        mask = waveform < -limiter_threshold
        temp = (waveform + limiter_threshold) * limiter_gain / (1 - limiter_threshold)
        peaked = torch.clamp(temp - limiter_threshold + shift, min=-limiter_threshold)
        return torch.where(mask, peaked, torch.clamp(waveform + shift, -1, 1))
    return torch.clamp(waveform + shift, -1, 1)


def gain(waveform: torch.Tensor, gain_db: float = 1.0) -> torch.Tensor:
    if gain_db == 0:
        return waveform
    return waveform * (10 ** (gain_db / 20))


def overdrive(waveform: torch.Tensor, gain: float = 20, colour: float = 20) -> torch.Tensor:
    """SoX overdrive: cubic waveshaper + one-pole smoothing recurrence.

    The loop ``last_out = temp[t] - last_in + 0.995*last_out`` is a first-order
    all-pole filter driven by ``temp[t] - temp[t-1]``: ``iir_apply`` runs it,
    kernel K4 for a CUDA float32 tensor.  A CUDA tensor of another dtype runs
    the plain recurrence on the card, as ``lfilter`` does there.
    """
    actual_shape = waveform.shape
    x = waveform.reshape(-1, actual_shape[-1])

    g = _db2linear(gain)
    colour_val = colour / 200
    temp = x * g + colour_val
    temp = torch.where(temp < -1, -2.0 / 3.0, torch.where(temp > 1, 2.0 / 3.0, temp - (temp**3) / 3))

    diff = (temp - F.pad(temp, (1, 0))[:, :-1])[:, None, :].contiguous()
    a_norm = torch.tensor([[1.0, -0.995]], dtype=x.dtype, device=x.device)
    if _filter_route(x.is_cuda, x.dtype, x.shape[-1], 2) == "plain":
        last_out = iir_plain(diff, a_norm[:, 1:])[:, 0]
    else:
        last_out = iir_apply(diff, a_norm)[:, 0]
    out = x * 0.5 + last_out * 0.75
    return torch.clamp(out, -1, 1).reshape(actual_shape)


def _generate_wave_table(
    wave_type: str,
    data_type: str,
    table_size: int,
    min_val: float,
    max_val: float,
    phase: float,
) -> np.ndarray:
    """SoX-style LFO wave table (host-side constant)."""
    phase_offset = int(phase / math.pi / 2 * table_size + 0.5)
    point = (np.arange(table_size) + phase_offset) % table_size
    if wave_type == "SINE":
        d = (np.sin(point.astype(np.float64) / table_size * 2 * math.pi) + 1) / 2
    elif wave_type == "TRIANGLE":
        d = point.astype(np.float64) * 2 / table_size
        value = (4 * point) // table_size
        d = np.where(value == 0, d + 0.5, d)
        d = np.where((value == 1) | (value == 2), 1.5 - d, d)
        d = np.where(value == 3, d - 1.5, d)
    else:
        raise ValueError(wave_type)
    d = d * (max_val - min_val) + min_val
    if data_type == "INT":
        d = np.where(d < 0, d - 0.5, d + 0.5).astype(np.int32)
    else:
        d = d.astype(np.float32)
    return d


def phaser(
    waveform: torch.Tensor,
    sample_rate: int,
    gain_in: float = 0.4,
    gain_out: float = 0.74,
    delay_ms: float = 3.0,
    decay: float = 0.4,
    mod_speed: float = 0.5,
    sinusoidal: bool = True,
) -> torch.Tensor:
    """SoX phaser: modulated delay line with feedback.

    Every row shares the read and write positions, computed on the host
    before the loop; each step is two launches over all rows (the delayed
    sum into the output, its decayed copy into the delay line), and a read
    can lie one step behind the last write, so the steps stay in order.
    """
    actual_shape = waveform.shape
    x = waveform.reshape(-1, actual_shape[-1])
    t_len = x.shape[-1]

    delay_buf_len = int((delay_ms * 0.001 * sample_rate) + 0.5)
    mod_buf_len = int(sample_rate / mod_speed + 0.5)
    mod_buf = _generate_wave_table(
        "SINE" if sinusoidal else "TRIANGLE", "INT", mod_buf_len, 1.0, float(delay_buf_len), math.pi / 2
    )
    # read and write positions of the delay line at every step
    steps = np.arange(t_len)
    mod_pos = steps % mod_buf_len
    delay_pos = steps % delay_buf_len  # position before increment at step i
    read_idx = ((delay_pos + mod_buf[mod_pos]) % delay_buf_len).tolist()
    write_idx = ((delay_pos + 1) % delay_buf_len).tolist()

    x_in = (x * gain_in).t().contiguous()  # (time, rows)
    buf = x.new_zeros((delay_buf_len, x.shape[0]))
    out = torch.empty_like(x_in)
    for t in range(t_len):
        torch.add(x_in[t], buf[read_idx[t]], out=out[t])
        torch.mul(out[t], decay, out=buf[write_idx[t]])
    out = out.t() * gain_out
    return torch.clamp(out, -1, 1).reshape(actual_shape)


def _flanger_tables(n_channels: int, t_len: int, sample_rate: int, delay: float, depth: float, width: float,
                    speed: float, phase: float, modulation: str, regen: float):
    """The flanger's gains and, for every step and channel, the delay line's integer lag and the
    fraction of a sample between its taps (host-side constants)."""
    feedback_gain = regen / 100
    delay_gain = width / 100
    channel_phase = phase / 100
    delay_min = delay / 1000
    delay_depth = depth / 1000

    in_gain = 1.0 / (1 + delay_gain)
    delay_gain = delay_gain / (1 + delay_gain) * (1 - abs(feedback_gain))

    delay_buf_length = int((delay_min + delay_depth) * sample_rate + 0.5) + 2
    lfo_length = int(sample_rate / speed)
    table_min = math.floor(delay_min * sample_rate + 0.5)
    table_max = delay_buf_length - 2.0
    lfo = _generate_wave_table(
        "SINE" if modulation == "sinusoidal" else "TRIANGLE",
        "FLOAT",
        lfo_length,
        float(table_min),
        float(table_max),
        3 * math.pi / 2,
    )
    steps = np.arange(t_len)
    # the write position decrements each step (from length - 1)
    buf_pos = (delay_buf_length - 1 - (steps % delay_buf_length)) % delay_buf_length
    lfo_pos = steps % lfo_length
    chan_phase = (np.arange(n_channels) * lfo_length * channel_phase + 0.5).astype(np.int64)
    delay_tensor = lfo[(lfo_pos[:, None] + chan_phase[None, :]) % lfo_length]  # (time, channels)
    return dict(feedback_gain=feedback_gain, in_gain=in_gain, delay_gain=delay_gain, length=delay_buf_length,
                buf_pos=buf_pos, delay=delay_tensor)


def _interpolate(d, frac, quadratic: bool, out: Optional[torch.Tensor] = None):
    """The delayed sample between taps d[0], d[1] (and d[2]) at ``frac``, into ``out`` if given."""
    if quadratic:
        dm = d[1:] - d[0]  # d1 - d0, d2 - d0
        d1m, d2m = dm[0], dm[1]
        half = d2m * 0.5
        a = half - d1m
        b = d1m * 2 - half
        return torch.add(d[0], (a * frac + b) * frac, out=out)
    return torch.add(d[0], (d[1] - d[0]) * frac, out=out)


def _split_delay(delay: np.ndarray, dtype: torch.dtype):
    """The LFO's delays (time, channels) in the signal's dtype, as the JAX package casts its
    table: their fractions (a tensor on the host) and integer parts (numpy)."""
    d = torch.from_numpy(delay).to(dtype)
    return d % 1.0, torch.floor(d).to(torch.int64).numpy()


def _flanger_loop(x: torch.Tensor, tab: dict, quadratic: bool) -> torch.Tensor:
    """The flanger's delay line with feedback, step by step: x (batch, channels, time) -> the
    delayed signal (batch, channels, time)."""
    n_batch, n_channels, t_len = x.shape
    length, taps = tab["length"], 3 if quadratic else 2
    buf_pos = tab["buf_pos"]
    frac, int_delay = _split_delay(tab["delay"], x.dtype)
    # read positions of each tap, every step and channel, as a gather index over the line
    read = (buf_pos[:, None, None] + int_delay[:, None, :] + np.arange(taps)[None, :, None]) % length
    read = _host_table(read[:, :, None, :], x.device).expand(t_len, taps, n_batch, n_channels)
    frac = _host_table(frac, x.device)  # (time, channels)
    write = buf_pos.tolist()
    fg = tab["feedback_gain"]

    xt = x.permute(2, 0, 1).contiguous()  # (time, batch, channels)
    buf = x.new_zeros((length, n_batch, n_channels))
    delayed = torch.empty_like(xt)
    last = x.new_zeros((n_batch, n_channels))
    for t in range(t_len):
        torch.add(xt[t], last * fg, out=buf[write[t]])
        last = _interpolate(torch.gather(buf, 0, read[t]), frac[t], quadratic, out=delayed[t])
    return delayed.permute(1, 2, 0)


def _flanger_gather(x: torch.Tensor, tab: dict, quadratic: bool) -> torch.Tensor:
    """The flanger without feedback, with no time loop: the loop's line then holds the input's
    past, so each tap is the input ``(int_delay + tap) mod length`` steps back (zero before the
    start), gathered for every step at once; the loop's arithmetic on the same values."""
    n_batch, n_channels, t_len = x.shape
    length, taps = tab["length"], 3 if quadratic else 2
    frac, int_delay = _split_delay(tab["delay"], x.dtype)
    frac = _host_table(frac, x.device).t()  # (channels, time)
    lag = (int_delay.T[None] + np.arange(taps)[:, None, None]) % length  # (taps, channels, time)
    src = _host_table(np.arange(t_len)[None, None, :] + length - lag, x.device)
    xp = F.pad(x, (length, 0))
    d = torch.gather(xp.expand(taps, *xp.shape), 3, src[:, None].expand(taps, n_batch, n_channels, t_len))
    return _interpolate(d, frac, quadratic)


def flanger(
    waveform: torch.Tensor,
    sample_rate: int,
    delay: float = 0.0,
    depth: float = 2.0,
    regen: float = 0.0,
    width: float = 71.0,
    speed: float = 0.5,
    phase: float = 25.0,
    modulation: str = "sinusoidal",
    interpolation: str = "linear",
) -> torch.Tensor:
    """SoX flanger: per-channel modulated delay with feedback, on (..., channel, time).

    With feedback (``regen`` not 0) a loop over time, every row at once, its
    read positions gathered from one table moved to the device before it;
    without, one gather of the input's past (the same values and arithmetic).
    """
    if modulation not in ("sinusoidal", "triangular"):
        raise ValueError('Only "sinusoidal" or "triangular" modulation allowed')
    if interpolation not in ("linear", "quadratic"):
        raise ValueError('Only "linear" or "quadratic" interpolation allowed')
    actual_shape = waveform.shape
    if actual_shape[-2] > 4:
        raise ValueError("Max 4 channels allowed")
    x = waveform.reshape(-1, actual_shape[-2], actual_shape[-1])
    tab = _flanger_tables(x.shape[1], x.shape[2], sample_rate, delay, depth, width, speed, phase, modulation, regen)
    quadratic = interpolation == "quadratic"
    if tab["feedback_gain"] == 0:
        delayed = _flanger_gather(x, tab, quadratic)
    else:
        delayed = _flanger_loop(x, tab, quadratic)
    out = x * tab["in_gain"] + delayed * tab["delay_gain"]
    return torch.clamp(out, -1, 1).reshape(actual_shape)


def _dither_noise(density_function: str, generator: Optional[torch.Generator], dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """The scalar a RPDF or GPDF dither adds to every sample, drawn from ``generator`` on its device
    (``None``: a generator on ``device`` seeded 0), in float64 for a float64 signal, else float32:
    one uniform less 0.5 (RPDF), or the sum of seven less 3.5 (GPDF)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    n = 1 if density_function == "RPDF" else 7
    u = torch.rand((n,), generator=generator, device=generator.device,
                   dtype=torch.float64 if dtype == torch.float64 else torch.float32)
    return u[0] - 0.5 if density_function == "RPDF" else torch.sum(u) - n / 2


def _apply_probability_distribution(
    waveform: torch.Tensor, density_function: str = "TPDF", generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    shape = waveform.shape
    x = waveform.reshape(-1, shape[-1])
    time_size = x.shape[-1] - 1

    number_of_bits = 16
    up_scaling = 2 ** (number_of_bits - 1) - 2
    signal_scaled = x * up_scaling
    down_scaling = 2 ** (number_of_bits - 1)

    if density_function in ("RPDF", "GPDF"):
        noise = _dither_noise(density_function, generator, x.dtype, x.device)
        signal_scaled_dis = signal_scaled + noise.to(x.device)
    else:  # TPDF: deterministic triangular window noise, as the reference
        tpdf = bartlett_window(time_size + 1, dtype=signal_scaled.dtype, device=x.device)
        signal_scaled_dis = signal_scaled + tpdf
    quantised = torch.round(signal_scaled_dis) / down_scaling
    return quantised.reshape(shape[:-1] + quantised.shape[-1:])


def dither(
    waveform: torch.Tensor,
    density_function: str = "TPDF",
    noise_shaping: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Dither to 16-bit depth with TPDF/RPDF/GPDF noise.

    RPDF and GPDF draw from ``generator``, on its device; ``None`` stands for
    a generator on the waveform's device seeded 0.
    """
    dithered = _apply_probability_distribution(waveform, density_function, generator)
    if not noise_shaping:
        return dithered
    error = dithered - waveform
    error = F.pad(error, (1, 0))[..., :-1]
    return dithered + error
