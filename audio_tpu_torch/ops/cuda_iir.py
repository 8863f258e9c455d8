"""Kernels K1 and K4: the difference-equation filter and its gradient.

CUDA C++ in ``csrc/lfilter.cu`` and ``csrc/iir.cu``, replacing the TPU kernels
of ``audio_tpu/ops/pallas_iir.py``:

* K1 ``lfilter_pallas``: the fused filter y = IIR_a(FIR_b(x)).  Two routes,
  chosen by :func:`lfilter_route` from the orders: ``"chunked"`` (order
  Pa - 1 <= 16, any Pb <= 129: a FIR stage over each pass of a row, then K4's
  chunked recurrence with :func:`chunk_plan_on_device`'s plan) and
  ``"serial"`` (one thread a row);
* K4 ``iir_pallas``: the all-pole recurrence y[t] = x[t] - sum_k a[k] y[t-k],
  which is the forward of ``iir_apply`` and, run backwards in time over the
  cotangent, the backward of both filters.  The kernel takes a ``reverse``
  flag, so the two flips of the JAX backward are indices, not copies.  Two
  routes, chosen by :func:`kernel_route` from the order: ``"chunked"`` (order
  <= 16: chunks of a row in parallel, their states carried by the powers of
  the companion matrix, which :func:`chunk_plan_on_device` makes, and whose
  plain version is ``ops/iir.py::chunk_plan``) and ``"serial"`` (one thread a
  row).

``lfilter_fused`` and ``iir_apply`` are ``torch.autograd.Function``s with the
analytic backward of ``audio_tpu/ops/iir.py``: dx through K4 on the reversed
cotangent, the coefficient gradients as one windowed sum a tap (no
(B, C, T, taps) gather is built).  ``iir_allpole`` launches K4 for a CUDA
tensor and runs ``iir_plain`` for a CPU tensor; ``lfilter_fused`` launches K1
for a CUDA tensor and runs ``lfilter_plain`` for a CPU tensor.  ``launches``
counts K1's launches, ``lfilter_route_launches`` those of each of K1's routes,
``iir_launches`` K4's and ``iir_route_launches`` those of each of K4's routes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .iir import CHUNK, CARRY_LEVELS, fir_causal, iir_plain

__all__ = [
    "MAX_TAPS",
    "chunk_plan_on_device",
    "iir_allpole",
    "iir_apply",
    "iir_launches",
    "iir_plain",
    "iir_route_launches",
    "kernel_route",
    "launches",
    "lfilter_fused",
    "lfilter_plain",
    "lfilter_route",
    "lfilter_route_launches",
]

# Coefficient rows of up to 129 taps (order <= 128), as in the JAX gate.
MAX_TAPS = 129

# K1's and K4's "chunked" routes take filters of up to this order (csrc/lfilter.cu, csrc/iir.cu)
CHUNKED_MAX_ORDER = 16

launches = 0
lfilter_route_launches = {"chunked": 0, "serial": 0}
iir_launches = 0
iir_route_launches = {"chunked": 0, "serial": 0}

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_LFILTER_CHUNKED_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_IIR_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_CHUNKED_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_PLAN_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def kernel_route(order: int) -> str:
    """K4's route for a filter of ``order`` (1 .. 128): ``"chunked"`` up to order 16, whatever the
    length (a signal shorter than one chunk included), ``"serial"`` past it."""
    return "chunked" if order <= CHUNKED_MAX_ORDER else "serial"


def lfilter_route(pa: int, pb: int) -> str:
    """K1's route for ``pa`` denominator and ``pb`` numerator taps (2 .. 129 and 1 .. 129):
    ``"chunked"`` up to order pa - 1 = 16, whatever ``pb`` and the length, ``"serial"`` past it."""
    return "chunked" if pa - 1 <= CHUNKED_MAX_ORDER else "serial"


def lfilter_plain(x: torch.Tensor, a_norm: torch.Tensor, b_norm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: the FIR stage, then the all-pole recurrence."""
    return iir_plain(fir_causal(x, b_norm), a_norm[:, 1:])


def _check_signal(name: str, x: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"{name} kernel takes x of shape (B, C, T); got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} kernel takes contiguous float32 x; got {x.dtype}")


def _check_coeffs(name: str, coeffs: torch.Tensor, x: torch.Tensor) -> None:
    c = x.shape[1]
    if coeffs.dim() != 2 or coeffs.shape[0] != c or coeffs.device != x.device:
        raise ValueError(f"{name} must be ({c}, taps) on {x.device}; got {tuple(coeffs.shape)} on {coeffs.device}")
    if coeffs.dtype != torch.float32 or not coeffs.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32")


def _lfilter_kernel(x: torch.Tensor, a_norm: torch.Tensor, b_norm: torch.Tensor) -> torch.Tensor:
    """One launch of K1 on CUDA tensors, on the route :func:`lfilter_route` names."""
    _check_signal("lfilter", x)
    pa, pb = a_norm.shape[-1], b_norm.shape[-1]
    _check_coeffs("a_norm", a_norm, x)
    _check_coeffs("b_norm", b_norm, x)
    if not (1 < pa <= MAX_TAPS and 1 <= pb <= MAX_TAPS):
        raise ValueError(f"lfilter kernel takes 2..{MAX_TAPS} a taps and 1..{MAX_TAPS} b taps; got {pa}, {pb}")
    return _lfilter_launch(lfilter_route(pa, pb), x, a_norm, b_norm)


def _lfilter_launch(route: str, x: torch.Tensor, a_norm: torch.Tensor, b_norm: torch.Tensor) -> torch.Tensor:
    """One launch of K1 on ``route`` (the wrapper's checks done); "chunked" first makes its plan."""
    global launches
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    bsz, c, t = x.shape
    pa, pb = a_norm.shape[-1], b_norm.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "chunked":
            plan = chunk_plan_on_device(a_norm[:, 1:].contiguous())
            fn = _build.bind("lfilter", "lfilter_f32_chunked", _LFILTER_CHUNKED_ARGTYPES)
            err = fn(x.data_ptr(), a_norm.data_ptr(), b_norm.data_ptr(), plan.data_ptr(), y.data_ptr(),
                     bsz * c, c, t, pa, pb, stream)
        else:
            fn = _build.bind("lfilter", "lfilter_f32", _ARGTYPES)
            err = fn(x.data_ptr(), a_norm.data_ptr(), b_norm.data_ptr(), y.data_ptr(), bsz * c, c, t, pa, pb, stream)
    _build.check_launch(err, f"lfilter ({route})")
    launches += 1
    lfilter_route_launches[route] += 1
    return y


def iir_allpole(x: torch.Tensor, a_tail: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """y[t] = x[t] - sum_{k=1..order} a_tail[:, k-1] y[t-k], zero initial state.

    x (B, C, T); a_tail (C, order), order <= 128.  With ``reverse`` the
    recurrence runs from the last sample to the first (``y[t+k]`` in place of
    ``y[t-k]``).  No gradient is recorded.  A CUDA tensor runs kernel K4
    (contiguous float32 only) on the route :func:`kernel_route` names; a CPU
    tensor runs :func:`iir_plain`.
    """
    with torch.no_grad():
        if not x.is_cuda:
            return iir_plain(x, a_tail, reverse)
        _check_signal("iir", x)
        _check_coeffs("a_tail", a_tail, x)
        order = a_tail.shape[-1]
        if order == 0:
            return x
        if order > MAX_TAPS - 1:
            raise ValueError(f"iir kernel takes an order of at most {MAX_TAPS - 1}; got {order}")
        return _iir_launch(kernel_route(order), x, a_tail, reverse)


def chunk_plan_on_device(a_tail: torch.Tensor) -> torch.Tensor:
    """The "chunked" route's plan of a contiguous float32 CUDA a_tail (C, order), order <= 16,
    made on the card in float64 by one launch: what ``ops/iir.py::chunk_plan`` makes."""
    c, order = a_tail.shape
    plan = torch.empty((c, CARRY_LEVELS * order * order + order * CHUNK), dtype=torch.float32, device=a_tail.device)
    with torch.cuda.device(a_tail.device):
        err = _build.bind("iir", "iir_chunk_plan", _PLAN_ARGTYPES)(a_tail.data_ptr(), plan.data_ptr(), c, order,
                                                                   torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "iir chunk plan")
    return plan


def _iir_launch(route: str, x: torch.Tensor, a_tail: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One launch of K4 on ``route`` (the wrapper's checks done)."""
    global iir_launches
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    bsz, c, t = x.shape
    order = a_tail.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "chunked":
            plan = chunk_plan_on_device(a_tail)
            fn = _build.bind("iir", "iir_f32_chunked", _CHUNKED_ARGTYPES)
            err = fn(x.data_ptr(), a_tail.data_ptr(), plan.data_ptr(), y.data_ptr(), bsz * c, c, t, order, int(reverse),
                     stream)
        else:
            fn = _build.bind("iir", "iir_f32", _IIR_ARGTYPES)
            err = fn(x.data_ptr(), a_tail.data_ptr(), y.data_ptr(), bsz * c, c, t, order, int(reverse), stream)
    _build.check_launch(err, f"iir ({route})")
    iir_launches += 1
    iir_route_launches[route] += 1
    return y


def _tap_sums(g: torch.Tensor, s: torch.Tensor, taps: int) -> torch.Tensor:
    """(C, taps): out[c, k] = sum_{b, t} g[b, c, t] * s[b, c, t - k], one pass a tap."""
    t = g.shape[-1]
    cols = []
    for k in range(taps):
        if k < t:
            cols.append((g[..., k:] * s[..., : t - k]).sum(dim=(0, 2)))
        else:
            cols.append(g.new_zeros((g.shape[1],)))
    return torch.stack(cols, dim=1)


class _IIRApplyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a_norm):
        y = iir_allpole(x, a_norm[:, 1:].contiguous())
        ctx.save_for_backward(a_norm, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        a_norm, y = ctx.saved_tensors
        # dx[t] = IIR(flip(dy))[T-1-t]: the same filter, run backwards in time
        dx = iir_allpole(dy.contiguous(), a_norm[:, 1:].contiguous(), reverse=True)
        # da[k] = -sum_{b,t} dx[b,c,t] * y[b,c,t-k]
        da = -_tap_sums(dx, y, a_norm.shape[-1]) if ctx.needs_input_grad[1] else None
        return dx, da


def iir_apply(x: torch.Tensor, a_norm: torch.Tensor) -> torch.Tensor:
    """All-pole filter with normalized denominator a_norm (C, order+1), a_norm[:, 0] = 1.

    x (B, C, T) -> y (B, C, T), with gradients to x and a_norm: the cotangent
    of x is the same filter run on the time-reversed cotangent.  CUDA tensors
    run kernel K4 forward and backward; CPU tensors run :func:`iir_plain`.
    """
    if a_norm.shape[-1] <= 1:
        return x
    return _IIRApplyFn.apply(x, a_norm)


class _LfilterFusedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a_norm, b_norm):
        y = _lfilter_kernel(x, a_norm, b_norm) if x.is_cuda else lfilter_plain(x, a_norm, b_norm)
        ctx.save_for_backward(x, y, a_norm, b_norm)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, a_norm, b_norm = ctx.saved_tensors
        t_len, pb = x.shape[-1], b_norm.shape[-1]
        # dv = IIR_a^T dy, the cotangent at the FIR stage's output
        dv = iir_allpole(dy.contiguous(), a_norm[:, 1:].contiguous(), reverse=True)
        dx = da = db = None
        if ctx.needs_input_grad[0]:
            # dx[t] = sum_k b[k] dv[t+k]: the FIR stage transposed
            dx = b_norm[:, 0, None] * dv
            for k in range(1, min(pb, t_len)):
                dx[..., : t_len - k] += b_norm[:, k, None] * dv[..., k:]
        if ctx.needs_input_grad[1]:
            da = -_tap_sums(dv, y, a_norm.shape[-1])
        if ctx.needs_input_grad[2]:
            db = _tap_sums(dv, x, pb)  # db[k] = sum_{b,t} dv[t] x[t-k]
        return dx, da, db


def lfilter_fused(x: torch.Tensor, a_norm: torch.Tensor, b_norm: torch.Tensor) -> torch.Tensor:
    """y = IIR_a(FIR_b(x)) per channel with zero initial state, with gradients to all three.

    x (B, C, T); a_norm (C, Pa), b_norm (C, Pb) with a_norm[:, 0] == 1 and
    Pa, Pb <= 129.  A CUDA tensor runs kernel K1 (float32 only) on the route
    :func:`lfilter_route` names and, in the backward, kernel K4; a CPU tensor runs :func:`lfilter_plain` and
    :func:`iir_plain`.
    """
    return _LfilterFusedFn.apply(x, a_norm, b_norm)
