"""Filterbank matrix constructors (mel / linear / DCT).

Same values as ``audio_tpu.functional._fbanks``: HTK and Slaney mel scales,
Slaney area normalization, triangular filters and the DCT-II matrix, built on
the host in float64 numpy and then cast onto ``device`` (default CUDA).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["melscale_fbanks", "linear_fbanks", "create_dct", "hz_to_mel", "mel_to_hz"]


def hz_to_mel(freq, mel_scale: str = "htk"):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    if mel_scale != "slaney":
        raise ValueError('mel_scale must be "htk" or "slaney"')
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(freq >= min_log_hz, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)


def mel_to_hz(mels, mel_scale: str = "htk"):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    if mel_scale != "slaney":
        raise ValueError('mel_scale must be "htk" or "slaney"')
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def _triangular_filterbank(all_freqs: np.ndarray, f_pts: np.ndarray) -> np.ndarray:
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_filter + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_filter + 2)
    down_slopes = (-1.0 * slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down_slopes, up_slopes))


def melscale_fbanks(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    norm: Optional[str] = None,
    mel_scale: str = "htk",
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """Mel filterbank of shape (n_freqs, n_mels); spec @ fb gives mel bins."""
    if norm is not None and norm != "slaney":
        raise ValueError('norm must be None or "slaney"')
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min = hz_to_mel(f_min, mel_scale)
    m_max = hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)
    fb = _triangular_filterbank(all_freqs, f_pts)
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return torch.as_tensor(fb, dtype=dtype, device=device)


def linear_fbanks(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_filter: int,
    sample_rate: int,
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """Linearly spaced triangular filterbank of shape (n_freqs, n_filter)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    f_pts = np.linspace(f_min, f_max, n_filter + 2)
    fb = _triangular_filterbank(all_freqs, f_pts)
    return torch.as_tensor(fb, dtype=dtype, device=device)


def create_dct(n_mfcc: int, n_mels: int, norm: Optional[str] = None, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """DCT-II basis of shape (n_mels, n_mfcc); mel @ dct gives cepstra."""
    if norm is not None and norm != "ortho":
        raise ValueError('norm must be None or "ortho"')
    n = np.arange(float(n_mels))
    k = np.arange(float(n_mfcc))[:, None]
    dct = np.cos(math.pi / float(n_mels) * (n + 0.5) * k)  # (n_mfcc, n_mels)
    if norm is None:
        dct = dct * 2.0
    else:
        dct[0] *= 1.0 / math.sqrt(2.0)
        dct = dct * math.sqrt(2.0 / float(n_mels))
    return torch.as_tensor(np.ascontiguousarray(dct.T), dtype=dtype, device=device)
