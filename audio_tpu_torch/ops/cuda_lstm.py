"""Kernel K7: one step of the layer-norm LSTM of the RNN-T predictor.

CUDA C++ in ``csrc/lstm.cu``, replacing the TPU kernel
``audio_tpu/ops/pallas_lstm.py::lstm_gate_step``.  ``lstm_gate_step`` launches
it for a CUDA tensor and runs ``lstm_gate_step_plain`` for a CPU tensor.
Three routes, chosen by :func:`kernel_route` from the type, the hidden size
and the weight's layout (:func:`weight_layout`): ``"wgmma"`` (bfloat16, the
weight as a ``torch.nn.Linear`` holds it, H a multiple of 64 up to 512: a row
tile spread over a cluster of H / 64 blocks, each owning 64 hidden units of
all four gates, :func:`wgmma_gate_columns`), ``"wmma"`` (bfloat16 in the
Linear layout at other H, a multiple of 16) and ``"simt"`` (float32, or a
row-major weight).  ``launches`` counts the kernel's launches,
``route_launches`` those of each route.  ``_ln`` is the LayerNorm both
versions share: fast variance, ``max(E[x^2] - E[x]^2, 0)``, with f32
statistics.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "MAX_HIDDEN",
    "WGMMA_UNITS",
    "kernel_route",
    "launches",
    "lstm_gate_step",
    "lstm_gate_step_plain",
    "route_launches",
    "weight_layout",
    "wgmma_gate_columns",
]

launches = 0
route_launches = {"wgmma": 0, "wmma": 0, "simt": 0}

# the "simt" route's block keeps 16 rows' gates and h, and a W tile, in shared memory:
# 4 (84 H + 8192) bytes of the 232,448 a block can opt in to; the other routes keep to it too
MAX_HIDDEN = 594
# the "wgmma" route: hidden units a block owns of each gate; a cluster has at most 8 blocks
WGMMA_UNITS = 64
_WGMMA_MAX_HIDDEN = 8 * WGMMA_UNITS

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 3 + [_P]
_WGMMA_ARGTYPES = [_P] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, _P]

_DTYPES = (torch.float32, torch.bfloat16)


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with the fast variance, on f32 ``x``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def weight_layout(w_p2g: torch.Tensor) -> str:
    """``"linear"`` where the (H, 4H) weight is the transposed view of a contiguous (4H, H)
    ``torch.nn.Linear`` weight, ``"row-major"`` otherwise."""
    hd = w_p2g.shape[0]
    return "linear" if w_p2g.dim() == 2 and not w_p2g.is_contiguous() and w_p2g.stride() == (1, hd) else "row-major"


def kernel_route(dtype: torch.dtype, hd: int, w_layout: str) -> Optional[str]:
    """The route of kernel K7 for a type, a hidden size and a weight layout; None where no
    route takes them (H past ``MAX_HIDDEN``, or a type other than float32 and bfloat16).

    ``"wgmma"`` for bfloat16 with the weight in the Linear layout, H a multiple of 64 up to
    512 (clusters of up to 8 blocks of 64 hidden units); ``"wmma"`` for bfloat16 in the Linear
    layout at another H that is a multiple of 16; ``"simt"`` for everything else (float32,
    or a row-major weight, which is read after a copy if it is not contiguous).
    """
    if dtype not in _DTYPES or not 1 <= hd <= MAX_HIDDEN:
        return None
    if dtype == torch.bfloat16 and w_layout == "linear":
        if hd % WGMMA_UNITS == 0 and hd <= _WGMMA_MAX_HIDDEN:
            return "wgmma"
        if hd % 16 == 0:
            return "wmma"
    return "simt"


def wgmma_gate_columns(hd: int) -> torch.Tensor:
    """(H / 64, 256) int64: the gate columns, that is the rows of the (4H, H) Linear weight, that
    block r of a "wgmma" cluster multiplies: gate q's hidden units [64 r, 64 r + 64) at
    [64 q, 64 q + 64) of its row, so that one thread holds the i, f, g and o of a unit."""
    ranks = torch.arange(hd // WGMMA_UNITS)[:, None, None]
    gates = torch.arange(4)[None, :, None]
    units = torch.arange(WGMMA_UNITS)[None, None, :]
    return (gates * hd + ranks * WGMMA_UNITS + units).reshape(hd // WGMMA_UNITS, 4 * WGMMA_UNITS)


def lstm_gate_step_plain(gx, h, c, w_p2g, g_scale, g_bias, c_scale, c_bias, eps: float):
    """Plain PyTorch version of K7: the product and all gate math in f32."""
    gates = _ln(gx.float() + h.float() @ w_p2g.float(), g_scale.float(), g_bias.float(), eps)
    i_g, f_g, c_g, o_g = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f_g) * c.float() + torch.sigmoid(i_g) * torch.tanh(c_g)
    c2 = _ln(c2, c_scale.float(), c_bias.float(), eps)
    h2 = torch.sigmoid(o_g) * torch.tanh(c2)
    return h2.to(h.dtype), c2.to(c.dtype)


def _check(gx, h, c, w_p2g, g_scale, g_bias, c_scale, c_bias) -> None:
    """What kernel K7 takes; raises on anything else."""
    dtype = gx.dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in (h, c, w_p2g)):
        raise TypeError("lstm_gate_step kernel takes gx, h, c and w_p2g all float32 or all bfloat16; got "
                        f"{gx.dtype}, {h.dtype}, {c.dtype}, {w_p2g.dtype}")
    ln = (g_scale, g_bias, c_scale, c_bias)
    if any(t.dtype != ln[0].dtype for t in ln) or ln[0].dtype not in (torch.float32, dtype):
        raise TypeError(f"lstm_gate_step kernel takes LayerNorm parameters all float32 or all {dtype}; got "
                        f"{[t.dtype for t in ln]}")
    if h.dim() != 2:
        raise ValueError(f"lstm_gate_step: h must be (N, H); got {tuple(h.shape)}")
    n, hd = h.shape
    if hd > MAX_HIDDEN:
        raise ValueError(f"lstm_gate_step kernel takes a hidden size of at most {MAX_HIDDEN}; got {hd}")
    for name, t, shape in (("gx", gx, (n, 4 * hd)), ("c", c, (n, hd)), ("w_p2g", w_p2g, (hd, 4 * hd)),
                           ("g_scale", g_scale, (4 * hd,)), ("g_bias", g_bias, (4 * hd,)),
                           ("c_scale", c_scale, (hd,)), ("c_bias", c_bias, (hd,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"lstm_gate_step: {name} must have shape {shape}; got {tuple(t.shape)}")


def lstm_gate_step(gx, h, c, w_p2g, g_scale, g_bias, c_scale, c_bias,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer-norm LSTM step on precomputed input gates.

    gx (N, 4H) the hoisted ``x @ W_x2g``; h, c (N, H) the carried state; w_p2g
    (H, 4H) the recurrent weight; g_* (4H,) and c_* (H,) the LayerNorm
    parameters of the gates and the cell.  Returns (h', c') in the state's
    dtype.  A CUDA tensor runs kernel K7 on the route :func:`kernel_route`
    names (float32 or bfloat16, H <= 594; anything else raises); a CPU tensor
    runs :func:`lstm_gate_step_plain`.

    ``w_p2g`` may be the transposed view of a ``torch.nn.Linear`` weight,
    ``linear.weight.t()``: in bfloat16 the kernel then reads the weight where
    it lies and multiplies on the tensor cores.  Any other layout or type is
    read row-major by the FP32-pipe kernel, after a copy if it is not
    contiguous.
    """
    if not gx.is_cuda:
        return lstm_gate_step_plain(gx, h, c, w_p2g, g_scale, g_bias, c_scale, c_bias, eps)
    _check(gx, h, c, w_p2g, g_scale, g_bias, c_scale, c_bias)
    route = kernel_route(gx.dtype, h.shape[1], weight_layout(w_p2g))
    return _launch(route, gx, h, c, w_p2g, g_scale, g_bias, c_scale, c_bias, eps)


def _launch(route: str, gx, h, c, w_p2g, g_scale, g_bias, c_scale, c_bias, eps: float):
    """One launch of K7 on ``route``, which must take the inputs (the wrapper's checks done)."""
    global launches
    tensors = [t.contiguous() for t in (gx, h, c, g_scale, g_bias, c_scale, c_bias)]
    if any(t.device != gx.device for t in tensors + [w_p2g]):
        raise ValueError(f"lstm_gate_step: every tensor must be on {gx.device}")
    n, hd = h.shape
    h2, c2 = torch.empty_like(tensors[1]), torch.empty_like(tensors[2])
    if n == 0:
        return h2, c2
    if route == "simt":
        w_p2g = w_p2g.contiguous()
    elif w_p2g.data_ptr() % 32:  # the Linear layout, on an address the tensor cores cannot load from
        w_p2g = w_p2g.t().clone().t()
    ptrs = [t.data_ptr() for t in tensors[:3]] + [w_p2g.data_ptr()] + [t.data_ptr() for t in tensors[3:]]
    ln_f32 = int(g_scale.dtype == torch.float32)
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            fn = _build.bind("lstm", "lstm_gate_step_wgmma", _WGMMA_ARGTYPES)
            err = fn(*ptrs, h2.data_ptr(), c2.data_ptr(), n, hd, float(eps), ln_f32, stream)
        else:
            fn = _build.bind("lstm", "lstm_gate_step", _ARGTYPES)
            err = fn(*ptrs, h2.data_ptr(), c2.data_ptr(), n, hd, float(eps), int(gx.dtype == torch.bfloat16), ln_f32,
                     int(route == "wmma"), stream)
    _build.check_launch(err, f"lstm_gate_step ({route})")
    launches += 1
    route_launches[route] += 1
    return h2, c2
