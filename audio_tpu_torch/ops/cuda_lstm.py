"""Kernel K7: one step of the layer-norm LSTM of the RNN-T predictor.

CUDA C++ in ``csrc/lstm.cu``, replacing the TPU kernel
``audio_tpu/ops/pallas_lstm.py::lstm_gate_step``.  ``lstm_gate_step`` launches
it for a CUDA tensor and runs ``lstm_gate_step_plain`` for a CPU tensor;
``launches`` counts the kernel's launches.  ``_ln`` is the LayerNorm both
share: fast variance, ``max(E[x^2] - E[x]^2, 0)``, with f32 statistics.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["MAX_HIDDEN", "lstm_gate_step", "lstm_gate_step_plain", "launches"]

launches = 0

# a block keeps 16 rows' gates and h, and a W tile, in shared memory:
# 4 (84 H + 8192) bytes of the 232,448 a block can opt in to
MAX_HIDDEN = 594

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 3 + [_P]
_QUERY_ARGTYPES = [ctypes.c_int, ctypes.c_int, _P]

_DTYPES = (torch.float32, torch.bfloat16)


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with the fast variance, on f32 ``x``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


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
    dtype.  A CUDA tensor runs kernel K7 (float32 or bfloat16, H <= 594); a
    CPU tensor runs :func:`lstm_gate_step_plain`.

    ``w_p2g`` may be the transposed view of a ``torch.nn.Linear`` weight,
    ``linear.weight.t()``: in bfloat16 (H a multiple of 16) the kernel then
    reads the weight where it lies and multiplies on the tensor cores.  Any
    other layout or type is read row-major by the FP32-pipe kernel, after a
    copy if it is not contiguous.
    """
    global launches
    if not gx.is_cuda:
        return lstm_gate_step_plain(gx, h, c, w_p2g, g_scale, g_bias, c_scale, c_bias, eps)
    _check(gx, h, c, w_p2g, g_scale, g_bias, c_scale, c_bias)
    tensors = [t.contiguous() for t in (gx, h, c, g_scale, g_bias, c_scale, c_bias)]
    if any(t.device != gx.device for t in tensors + [w_p2g]):
        raise ValueError(f"lstm_gate_step: every tensor must be on {gx.device}")
    n, hd = h.shape
    h2, c2 = torch.empty_like(tensors[1]), torch.empty_like(tensors[2])
    if n == 0:
        return h2, c2
    bf16 = int(gx.dtype == torch.bfloat16)
    with torch.cuda.device(gx.device):
        col_major = not w_p2g.is_contiguous() and w_p2g.stride() == (1, hd) and bool(
            _build.bind("lstm", "lstm_gate_step_takes_col_major", _QUERY_ARGTYPES)(hd, bf16, w_p2g.data_ptr()))
        if not col_major:
            w_p2g = w_p2g.contiguous()
        fn = _build.bind("lstm", "lstm_gate_step", _ARGTYPES)
        err = fn(*(t.data_ptr() for t in tensors[:3]), w_p2g.data_ptr(), *(t.data_ptr() for t in tensors[3:]),
                 h2.data_ptr(), c2.data_ptr(), n, hd, float(eps), bf16, int(g_scale.dtype == torch.float32),
                 int(col_major), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "lstm_gate_step")
    launches += 1
    return h2, c2
