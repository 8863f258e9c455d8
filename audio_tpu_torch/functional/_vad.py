"""Voice activity detection (sox ``vad`` effect semantics), on the waveform's device.

Same semantics as ``audio_tpu.functional._vad``: every measurement window's
spectrum in one batched real FFT, then the noise and measurement state
machine a window at a time over every channel at once, on the device.  The
boot counter's course does not depend on the data, so it stays a host
integer and the loop reads nothing back.  The measures (a few values a
window and channel) are then read to the host once, where the trigger
search and the data-dependent trim run, as in the JAX package: the output
length depends on the data.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["vad"]


def _vad_measures(
    frames: torch.Tensor,  # (C, K, measure_len_ws) raw samples per window
    spectrum_window: torch.Tensor,
    cepstrum_window: torch.Tensor,
    dft_len_ws: int,
    spectrum_start: int,
    spectrum_end: int,
    cepstrum_start: int,
    cepstrum_end: int,
    noise_reduction_amount: float,
    measure_smooth_time_mult: float,
    noise_up_time_mult: float,
    noise_down_time_mult: float,
    trigger_meas_time_mult: float,
    boot_count_max: int,
):
    """All K measurement values and smoothed trigger levels, each (K, C), on the frames' device."""
    c, k, mlen = frames.shape
    sl = spectrum_end - spectrum_start
    buf = F.pad(frames * spectrum_window, (0, dft_len_ws - mlen))
    d_abs = torch.abs(torch.fft.rfft(buf, dim=-1))[..., spectrum_start:spectrum_end]  # (C, K, S)

    half = dft_len_ws >> 1
    norm = cepstrum_end - cepstrum_start
    spec = torch.zeros((c, sl), dtype=frames.dtype, device=frames.device)
    noise = torch.zeros_like(spec)
    mean_meas = torch.zeros((c,), dtype=frames.dtype, device=frames.device)
    boot = 0
    measures, means = [], []
    for i in range(k):
        booting = boot >= 0
        mult = boot / (1.0 + boot) if booting else measure_smooth_time_mult
        spec = spec * mult + d_abs[:, i] * (1.0 - mult)
        d2 = spec**2
        if booting:
            noise = d2
        else:
            nmult = torch.where(d2 > noise, noise_up_time_mult, noise_down_time_mult)
            noise = noise * nmult + d2 * (1.0 - nmult)
        d = torch.sqrt(torch.clamp(d2 - noise_reduction_amount * noise, min=0.0))
        ceps_buf = F.pad(d * cepstrum_window, (spectrum_start, half - spectrum_end))
        ceps = torch.fft.rfft(ceps_buf, dim=-1)[:, cepstrum_start:cepstrum_end]
        result = torch.sum(torch.abs(ceps) ** 2, dim=-1)
        meas = torch.where(result > 0, torch.clamp(21.0 + torch.log(result / norm), min=0.0),
                           torch.zeros_like(result))
        mean_meas = mean_meas * trigger_meas_time_mult + meas * (1.0 - trigger_meas_time_mult)
        boot = (-1 if boot == boot_count_max else boot + 1) if booting else -1
        measures.append(meas)
        means.append(mean_meas)
    return torch.stack(measures), torch.stack(means)


def vad(
    waveform: torch.Tensor,
    sample_rate: int,
    trigger_level: float = 7.0,
    trigger_time: float = 0.25,
    search_time: float = 1.0,
    allowed_gap: float = 0.25,
    pre_trigger_time: float = 0.0,
    boot_time: float = 0.35,
    noise_up_time: float = 0.1,
    noise_down_time: float = 0.01,
    noise_reduction_amount: float = 1.35,
    measure_freq: float = 20.0,
    measure_duration: Optional[float] = None,
    measure_smooth_time: float = 0.4,
    hp_filter_freq: float = 50.0,
    lp_filter_freq: float = 6000.0,
    hp_lifter_freq: float = 150.0,
    lp_lifter_freq: float = 2000.0,
) -> torch.Tensor:
    """Trim silence from the front of a recording (sox vad semantics).

    ``waveform`` is `(time,)` or `(channels, time)`; multi-channel input is
    trimmed to the earliest voice activity in any channel. Returns audio of
    dimension `(..., trimmed_time)`.
    """
    measure_duration = 2.0 / measure_freq if measure_duration is None else measure_duration

    measure_len_ws = int(sample_rate * measure_duration + 0.5)
    measure_len_ns = measure_len_ws
    dft_len_ws = 16
    while dft_len_ws < measure_len_ws:
        dft_len_ws *= 2

    measure_period_ns = int(sample_rate / measure_freq + 0.5)
    measures_len = math.ceil(search_time * measure_freq)
    search_pre_trigger_len_ns = measures_len * measure_period_ns
    gap_len = int(allowed_gap * measure_freq + 0.5)

    fixed_pre_trigger_len_ns = int(pre_trigger_time * sample_rate + 0.5)
    samples_len_ns = fixed_pre_trigger_len_ns + search_pre_trigger_len_ns + measure_len_ns

    dev = waveform.device
    spectrum_window = (2.0 / math.sqrt(float(measure_len_ws))) * torch.as_tensor(
        np.hanning(measure_len_ws + 1)[:-1], dtype=torch.float32, device=dev
    )

    spectrum_start = max(int(hp_filter_freq / sample_rate * dft_len_ws + 0.5), 1)
    spectrum_end = min(int(lp_filter_freq / sample_rate * dft_len_ws + 0.5), dft_len_ws // 2)

    sl = spectrum_end - spectrum_start
    cepstrum_window = (2.0 / math.sqrt(float(spectrum_end) - spectrum_start)) * torch.as_tensor(
        np.hanning(sl + 1)[:-1], dtype=torch.float32, device=dev
    )

    cepstrum_start = math.ceil(sample_rate * 0.5 / lp_lifter_freq)
    cepstrum_end = min(math.floor(sample_rate * 0.5 / hp_lifter_freq), dft_len_ws // 4)
    if cepstrum_end <= cepstrum_start:
        raise ValueError(
            "Expected cepstrum_start to be smaller than cepstrum_end."
            f"Found: cepstrum_start: {cepstrum_start}, cepstrum_end: {cepstrum_end}."
        )

    noise_up_time_mult = math.exp(-1.0 / (noise_up_time * measure_freq))
    noise_down_time_mult = math.exp(-1.0 / (noise_down_time * measure_freq))
    measure_smooth_time_mult = math.exp(-1.0 / (measure_smooth_time * measure_freq))
    trigger_meas_time_mult = math.exp(-1.0 / (trigger_time * measure_freq))
    boot_count_max = int(boot_time * measure_freq - 0.5)

    shape = waveform.shape
    flat = waveform.reshape(-1, shape[-1])
    n_channels, ilen = flat.shape

    positions = list(range(measure_len_ns, ilen, measure_period_ns))
    if positions:
        # window k starts at positions[k] - measure_len_ws = k * measure_period_ns
        frames = flat.unfold(-1, measure_len_ws, measure_period_ns)[:, : len(positions)]  # (C, K, len)
        measures, mean_meas = _vad_measures(
            frames.to(torch.float32),
            spectrum_window,
            cepstrum_window,
            dft_len_ws,
            spectrum_start,
            spectrum_end,
            cepstrum_start,
            cepstrum_end,
            noise_reduction_amount,
            measure_smooth_time_mult,
            noise_up_time_mult,
            noise_down_time_mult,
            trigger_meas_time_mult,
            boot_count_max,
        )
        measures = measures.cpu().numpy()  # (K, C): the one read back, as the JAX package's
        mean_meas = mean_meas.cpu().numpy()
    else:
        measures = np.zeros((0, n_channels), np.float32)
        mean_meas = np.zeros((0, n_channels), np.float32)

    # host-side trigger search over the (small) measurement sequence
    has_triggered = False
    flushed_len_ns = 0
    pos = 0
    trig_win = mean_meas >= trigger_level  # (K, C)
    hit = np.argwhere(trig_win.any(axis=1))
    if hit.size:
        k_star = int(hit[0, 0])
        pos = positions[k_star]
        has_triggered = True
        c_star = int(np.argmax(trig_win[k_star]))
        n = measures_len
        measures_index = k_star % n
        # the measures ring buffer as it stands at the trigger window
        ring = np.zeros((n_channels, n), np.float32)
        lo = max(0, k_star - n + 1)
        for kk in range(lo, k_star + 1):
            ring[:, kk % n] = measures[kk]
        num_measures_to_flush = 0
        for i in range(c_star, n_channels):
            k = measures_index
            j_trigger = n
            j_zero = n
            j = 0
            for j in range(n):
                if (ring[i, k] >= trigger_level) and (j <= j_trigger + gap_len):
                    j_zero = j_trigger = j
                elif (ring[i, k] == 0) and (j_trigger >= j_zero):
                    j_zero = j
                k = (k + n - 1) % n
            j = min(j, j_zero)
            num_measures_to_flush = min(max(num_measures_to_flush, j), n)
        flushed_len_ns = (measures_len - num_measures_to_flush) * measure_period_ns
    elif positions:
        pos = positions[-1]

    if not has_triggered and shape[-1] >= fixed_pre_trigger_len_ns:
        res = flat[..., :fixed_pre_trigger_len_ns]
        return res.reshape(shape[:-1] + (fixed_pre_trigger_len_ns,))

    res = flat[:, max(pos - samples_len_ns + flushed_len_ns, 0):]
    return res.reshape(shape[:-1] + res.shape[-1:])
