"""Kernel K1: the fused difference-equation filter y = IIR_a(FIR_b(x)).

CUDA C++ in ``csrc/lfilter.cu``, replacing the TPU kernel
``audio_tpu/ops/pallas_iir.py::lfilter_pallas``.  ``lfilter_fused`` launches
it for a CUDA tensor and runs ``lfilter_plain``, the plain PyTorch version,
for a CPU tensor.  ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .iir import fir_causal, iir_apply

__all__ = ["MAX_TAPS", "lfilter_fused", "lfilter_plain", "launches"]

# Coefficient rows of up to 129 taps (order <= 128), as in the JAX gate.
MAX_TAPS = 129

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def lfilter_plain(x: torch.Tensor, a_norm: torch.Tensor, b_norm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: the FIR stage, then the all-pole recurrence."""
    return iir_apply(fir_causal(x, b_norm), a_norm)


def lfilter_fused(x: torch.Tensor, a_norm: torch.Tensor, b_norm: torch.Tensor) -> torch.Tensor:
    """y = IIR_a(FIR_b(x)) per channel with zero initial state.

    x (B, C, T); a_norm (C, Pa), b_norm (C, Pb) with a_norm[:, 0] == 1 and
    Pa, Pb <= 129.  A CUDA tensor runs kernel K1 (float32 only); a CPU tensor
    runs :func:`lfilter_plain`.
    """
    global launches
    if not x.is_cuda:
        return lfilter_plain(x, a_norm, b_norm)
    if torch.is_grad_enabled() and (x.requires_grad or a_norm.requires_grad or b_norm.requires_grad):
        raise NotImplementedError(
            "lfilter's gradient on CUDA arrives with the training slice of the port "
            "(the all-pole kernel and the two autograd.Functions); call it under "
            "torch.no_grad() or on CPU tensors"
        )
    if x.dim() != 3:
        raise ValueError(f"lfilter kernel takes x of shape (B, C, T); got {tuple(x.shape)}")
    bsz, c, t = x.shape
    pa, pb = a_norm.shape[-1], b_norm.shape[-1]
    for name, coeffs, taps in (("a_norm", a_norm, pa), ("b_norm", b_norm, pb)):
        if coeffs.shape != (c, taps) or coeffs.device != x.device:
            raise ValueError(f"{name} must be ({c}, taps) on {x.device}; got {tuple(coeffs.shape)} on {coeffs.device}")
        if coeffs.dtype != torch.float32 or not coeffs.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"lfilter kernel takes contiguous float32 x; got {x.dtype}")
    if not (1 < pa <= MAX_TAPS and 1 <= pb <= MAX_TAPS):
        raise ValueError(f"lfilter kernel takes 2..{MAX_TAPS} a taps and 1..{MAX_TAPS} b taps; got {pa}, {pb}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        fn = _build.bind("lfilter", "lfilter_f32", _ARGTYPES)
        err = fn(x.data_ptr(), a_norm.data_ptr(), b_norm.data_ptr(), y.data_ptr(),
                 bsz * c, c, t, pa, pb, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "lfilter")
    launches += 1
    return y
