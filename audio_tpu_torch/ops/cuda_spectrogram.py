"""Kernel K2: fused framing + windowed DFT + power (+ mel GEMM, + sqrt).

CUDA C++ in ``csrc/spectrogram.cu``, replacing the TPU kernel
``audio_tpu/ops/pallas_spectrogram.py::power_spectrogram_pallas``.
``power_spectrogram`` launches it for a CUDA tensor and runs
``power_spectrogram_plain``, the plain PyTorch version (frames, rfft, power),
for a CPU tensor.  Output is time-major (B, n_frames, bins).  ``launches``
counts the kernel's launches.  Under autograd the kernel's backward recomputes
through the plain version, as the JAX package's ``_power_spec_kernel_tm`` does:
the JAX package has no backward kernel here either.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

__all__ = ["power_spectrogram", "power_spectrogram_plain", "spectrogram_supported", "launches"]

# Tile sizes of csrc/spectrogram.cu: the DFT operator is padded to them.
_BK = 16
_BN = 64

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def spectrogram_supported(n_fft: int, hop: int, power) -> bool:
    """Configurations kernel K2 takes (the JAX kernel's limits)."""
    if power not in (1.0, 2.0):
        return False
    return n_fft <= 2048 and 32 <= hop <= n_fft


def power_spectrogram_plain(
    waveform: torch.Tensor,
    window: torch.Tensor,
    n_fft: int,
    hop_length: int,
    power: float = 2.0,
    fb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K2 (the JAX package's ``_power_spec_ref_tm``).

    ``waveform`` (..., T) is already center padded; returns (..., n_frames, bins).
    """
    if fb is not None and power != 2.0:
        raise ValueError("mel fusion requires power=2.0")
    if waveform.dtype not in (torch.float32, torch.float64):
        waveform = waveform.float()  # rfft needs f32/f64
    frames = waveform.unfold(-1, n_fft, hop_length) * window.to(waveform.dtype)
    s = torch.fft.rfft(frames, n=n_fft)
    p = s.real**2 + s.imag**2
    if fb is not None:
        p = p @ fb.to(p.dtype)
    if power == 1.0:
        p = torch.sqrt(p)
    return p


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int, device: torch.device) -> torch.Tensor:
    """(k_pad, n_cols) float32: column 2f = cos, 2f+1 = -sin of bin f.

    Built in float64 on the host, then cast; zero past n_fft rows and
    2 * n_freq columns.
    """
    n_freq = n_fft // 2 + 1
    nn = np.arange(n_fft, dtype=np.float64)
    f = np.arange(n_freq, dtype=np.float64)
    ang = (2.0 * math.pi / n_fft) * f[None, :] * nn[:, None]  # (n_fft, n_freq)
    basis = np.zeros((_ceil_to(n_fft, _BK), _ceil_to(2 * n_freq, _BN)), np.float32)
    basis[:n_fft, 0 : 2 * n_freq : 2] = np.cos(ang)
    basis[:n_fft, 1 : 2 * n_freq : 2] = -np.sin(ang)
    return torch.as_tensor(basis, device=device)


# (n_fft, id(window), window._version) -> (weak reference to the window, its operator)
_operators: dict = {}
_MAX_OPERATORS = 8


def _windowed_operator(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The windowed DFT operator K2 takes, cast(trig) * window, cached per window.

    An entry holds while the same window tensor lives unmodified: an in-place
    write bumps its version, and a dead window's weak reference fails.
    Inference tensors keep no version, so their operator is built anew.
    """
    key = None if window.is_inference() else (n_fft, id(window), window._version)
    hit = _operators.get(key)
    if hit is not None and hit[0]() is window:
        return hit[1]
    basis = _dft_basis(n_fft, window.device)
    d = (basis * F.pad(window, (0, basis.shape[0] - n_fft))[:, None]).contiguous()
    if key is not None:
        if len(_operators) >= _MAX_OPERATORS:
            _operators.pop(next(iter(_operators)))
        _operators[key] = (weakref.ref(window), d)
    return d


def power_spectrogram(
    waveform: torch.Tensor,
    window: torch.Tensor,
    n_fft: int,
    hop_length: int,
    power: float = 2.0,
    fb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Time-major power/mel spectrogram (B, n_frames, n_freq | n_mels).

    ``waveform`` (B, T) is already center padded; ``window`` (n_fft,);
    ``fb`` (n_freq, n_mels) fuses the mel product (power 2.0 only).  A CUDA
    tensor runs kernel K2 in exact float32; a CPU tensor runs
    :func:`power_spectrogram_plain`.
    """
    if fb is not None and power != 2.0:
        raise ValueError("mel fusion requires power=2.0")
    if not waveform.is_cuda:
        return power_spectrogram_plain(waveform, window, n_fft, hop_length, power, fb)
    return _PowerSpectrogramFn.apply(waveform, window, fb, n_fft, hop_length, power)


def _power_spectrogram_kernel(waveform, window, n_fft: int, hop_length: int, power: float, fb) -> torch.Tensor:
    """One launch of K2 on CUDA tensors."""
    global launches
    if not spectrogram_supported(n_fft, hop_length, power):
        raise ValueError(f"spectrogram kernel does not take n_fft={n_fft}, hop={hop_length}, power={power}")
    if waveform.dim() != 2 or waveform.dtype != torch.float32 or not waveform.is_contiguous():
        raise ValueError(f"spectrogram kernel takes contiguous float32 (B, T); got {waveform.dtype} "
                         f"{tuple(waveform.shape)}")
    b, t = waveform.shape
    if t < n_fft:
        raise ValueError(f"padded signal of {t} samples is shorter than n_fft={n_fft}")
    n_freq = n_fft // 2 + 1
    if window.shape != (n_fft,) or window.dtype != torch.float32 or window.device != waveform.device:
        raise ValueError(f"window must be float32 ({n_fft},) on {waveform.device}")
    n_mels = 0
    if fb is not None:
        if (fb.dim() != 2 or fb.shape[0] != n_freq or fb.dtype != torch.float32
                or fb.device != waveform.device or not fb.is_contiguous()):
            raise ValueError(f"fb must be contiguous float32 ({n_freq}, n_mels) on {waveform.device}")
        n_mels = fb.shape[1]
    n_frames = 1 + (t - n_fft) // hop_length
    d = _windowed_operator(window, n_fft)
    out = torch.empty((b, n_frames, n_mels or n_freq), dtype=torch.float32, device=waveform.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(waveform.device):
        fn = _build.bind("spectrogram", "power_spectrogram_f32", _ARGTYPES)
        err = fn(waveform.data_ptr(), d.data_ptr(), 0 if fb is None else fb.data_ptr(), out.data_ptr(),
                 b, t, n_fft, hop_length, n_frames, n_freq, d.shape[1], n_mels, int(power == 1.0),
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "power_spectrogram")
    launches += 1
    return out


class _PowerSpectrogramFn(torch.autograd.Function):
    """K2 forward; the backward differentiates the plain version on the saved inputs."""

    @staticmethod
    def forward(ctx, waveform, window, fb, n_fft, hop_length, power):
        ctx.save_for_backward(waveform, window, fb)
        ctx.config = (n_fft, hop_length, power)
        return _power_spectrogram_kernel(waveform, window, n_fft, hop_length, power, fb)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad[:3])]
            out = power_spectrogram_plain(inputs[0], inputs[1], *ctx.config, fb=inputs[2])
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return tuple(next(grads) if t is not None and t.requires_grad else None for t in inputs) + (None,) * 3
