"""Window functions, built in float64 with numpy and then cast.

Same values as ``audio_tpu._internal.windows`` (torch's ``periodic=True``
convention by default).  Factory functions take ``device=``, default CUDA.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "hann_window",
    "hamming_window",
    "blackman_window",
    "bartlett_window",
    "kaiser_window",
    "povey_window",
    "get_window",
]


def _raised_cosine(window_length: int, periodic: bool, a0: float, a1: float, a2: float,
                   dtype, device) -> torch.Tensor:
    if window_length == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    n = np.arange(window_length, dtype=np.float64)
    denom = window_length if periodic else window_length - 1
    w = a0 - a1 * np.cos(2.0 * math.pi * n / denom) + a2 * np.cos(4.0 * math.pi * n / denom)
    return torch.as_tensor(w, dtype=dtype, device=device)


def hann_window(window_length: int, periodic: bool = True, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    return _raised_cosine(window_length, periodic, 0.5, 0.5, 0.0, dtype, device)


def hamming_window(
    window_length: int,
    periodic: bool = True,
    alpha: float = 0.54,
    beta: float = 0.46,
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    return _raised_cosine(window_length, periodic, alpha, beta, 0.0, dtype, device)


def blackman_window(window_length: int, periodic: bool = True, dtype=torch.float32,
                    device="cuda") -> torch.Tensor:
    return _raised_cosine(window_length, periodic, 0.42, 0.5, 0.08, dtype, device)


def bartlett_window(window_length: int, periodic: bool = True, dtype=torch.float32,
                    device="cuda") -> torch.Tensor:
    if window_length == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    n = np.arange(window_length, dtype=np.float64)
    denom = window_length if periodic else window_length - 1
    w = 1.0 - np.abs(2.0 * n / denom - 1.0)
    return torch.as_tensor(w, dtype=dtype, device=device)


def kaiser_window(
    window_length: int,
    periodic: bool = True,
    beta: float = 12.0,
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    if window_length == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    length = window_length if periodic else window_length - 1
    n = np.arange(window_length, dtype=np.float64)
    ratio = 2.0 * n / length - 1.0
    w = np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - ratio**2))) / np.i0(beta)
    return torch.as_tensor(w, dtype=dtype, device=device)


def povey_window(window_length: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Kaldi's "povey" window: hann(sym)**0.85."""
    n = np.arange(window_length, dtype=np.float64)
    w = (0.5 - 0.5 * np.cos(2.0 * math.pi * n / (window_length - 1))) ** 0.85
    return torch.as_tensor(w, dtype=dtype, device=device)


_WINDOWS = {
    "hann": hann_window,
    "hamming": hamming_window,
    "blackman": blackman_window,
    "bartlett": bartlett_window,
    "kaiser": kaiser_window,
}


def get_window(name: str, window_length: int, periodic: bool = True, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    try:
        fn = _WINDOWS[name]
    except KeyError:
        raise ValueError(f"Unknown window {name!r}; available: {sorted(_WINDOWS)}") from None
    return fn(window_length, periodic=periodic, dtype=dtype, device=device)
