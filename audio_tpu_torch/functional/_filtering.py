"""Sox-style filtering: lfilter, filtfilt and the biquad designs.

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
"""

from __future__ import annotations

import math

import torch

from ..ops.cuda_iir import MAX_TAPS, iir_apply, lfilter_fused
from ..ops.iir import fir_causal, iir_plain

__all__ = [
    "allpass_biquad",
    "band_biquad",
    "bandpass_biquad",
    "bandreject_biquad",
    "bass_biquad",
    "biquad",
    "deemph_biquad",
    "equalizer_biquad",
    "filtfilt",
    "highpass_biquad",
    "lfilter",
    "lowpass_biquad",
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
