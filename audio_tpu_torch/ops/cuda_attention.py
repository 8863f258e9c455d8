"""Kernel K9: fused Emformer attention, forward and backward.

CUDA C++ in ``csrc/attention.cu``, replacing the TPU kernels of
``audio_tpu/ops/pallas_attention.py::emformer_attention``:

    O = softmax(Q K^T + mask_bias + key_bias) V      per (batch, head)

with f32 scores and softmax, the probabilities cast to V's type before the
second product, and the f32 row maximum and log row sum saved for the backward,
which recomputes the probabilities (dV = P^T dO, dS = P (dO V^T - rowsum(P dO V^T)),
dQ = dS K, dK = dS^T Q).  The TPU kernel saves their sum, the logsumexp; they are
kept apart here so that a fully masked row, whose maximum is the mask's -1e8,
keeps its uniform probabilities in the backward.  The (Tq, Tk) scores never
reach device memory.

``emformer_attention`` runs :class:`EmformerAttentionFn` (both directions)
for CUDA tensors and ``emformer_attention_plain``, the plain PyTorch version
whose gradient is autograd's, for CPU tensors.  Two routes of kernels, chosen
by :func:`kernel_route` from the type and the shape alone: ``"wgmma"``
(bfloat16 on Hopper's warpgroup products, operands copied by TMA) and
``"tiled"`` (float32, deep heads and more keys).  The kernels read q, k,
v through their strides, so the model's (T, B, H * dh) tensors are passed as
permuted views and no transposed copy is made; outputs and gradients are
allocated in that layout too.  ``launches`` counts the calls of each
direction, ``route_launches`` the calls of each route and direction.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "EmformerAttentionFn",
    "emformer_attention",
    "emformer_attention_plain",
    "fused_attention_supported",
    "kernel_route",
    "launches",
    "route_launches",
]

launches = {"emformer_attention_fwd": 0, "emformer_attention_bwd": 0}
route_launches = {"wgmma_fwd": 0, "wgmma_bwd": 0, "tiled_fwd": 0, "tiled_bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_FWD_ARGTYPES = [_P] * 7 + [_I] * 5 + [_STRIDES, _I, _P]
_BWD_ARGTYPES = [_P] * 12 + [_I] * 5 + [_STRIDES, _I, _P]
_WGMMA_FWD_ARGTYPES = [_P] * 7 + [_I] * 5 + [_STRIDES, _P]
_WGMMA_BWD_ARGTYPES = [_P] * 11 + [_I] * 5 + [_STRIDES, _P]
_TMA_STRIDE_BYTES = 1 << 40  # a tensor map's strides lie below this
_DTYPES = (torch.float32, torch.bfloat16)


def fused_attention_supported(b: int, h: int, tq: int, tk: int, dh: int) -> bool:
    """Shapes kernel K9 takes: the JAX package's gate (``fused_attention_supported`` with
    the model's ``tq >= 32 and tk >= 32``).  A head deeper than 128 goes through the
    kernels 128 columns at a time."""
    tile = tq * tk * 4 * 2
    qkvo = (2 * tq + 2 * tk) * dh * 4
    return tq >= 32 and tk >= 32 and dh % 8 == 0 and (tile + qkvo) < 8 * 1024 * 1024


def kernel_route(dtype: torch.dtype, tq: int, tk: int, dh: int) -> str:
    """The kernels that run a shape inside :func:`fused_attention_supported`.

    ``"wgmma"`` for bfloat16 with dh <= 128 and Tk <= 192 where dh <= 64 or Tk <= 128
    where dh <= 128: all of a (batch, head)'s keys lie on chip, and each warpgroup of the
    backward holds the dK and dV of its 64 keys in registers; the query rows stream, so
    Tq has no limit of its own.  ``"tiled"`` for everything else, float32 included (wgmma
    has no full-float32 product).
    """
    key_limit = 192 if dh <= 64 else 128
    if dtype == torch.bfloat16 and dh <= 128 and tk <= key_limit:
        return "wgmma"
    return "tiled"


def emformer_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask_bias: torch.Tensor,
                             key_bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9: scores and softmax in f32, probabilities cast to
    the value type before the second product.  Shapes as :func:`emformer_attention`."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores + mask_bias.float()[None, None] + key_bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def _kernel_view(t: torch.Tensor, tma: bool = False) -> torch.Tensor:
    """``t`` as the kernels read it: last axis contiguous, every other stride and the
    base a multiple of 16 bytes; for a tensor map (``tma``) also every other stride
    above 0 and below 2**40 bytes.  Anything else is copied."""
    vec = 16 // t.element_size()
    outer = t.stride()[:-1]
    ok = t.stride(-1) == 1 and all(s % vec == 0 for s in outer) and t.data_ptr() % 16 == 0
    if tma:
        ok = ok and all(0 < s * t.element_size() < _TMA_STRIDE_BYTES for s in outer)
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _time_major_empty(b: int, h: int, t: int, dh: int, like: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, T, dh) view of a contiguous (T, B, H, dh) tensor: the model's layout."""
    return torch.empty((t, b, h, dh), dtype=like.dtype, device=like.device).permute(1, 2, 0, 3)


def _strides(*tensors: torch.Tensor):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check(q, k, v, mask_bias, key_bias) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"emformer_attention kernel takes q, k, v all float32 or all bfloat16; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"emformer_attention: q (B, H, Tq, dh) and k, v (B, H, Tk, dh) expected; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if not fused_attention_supported(b, h, tq, tk, dh):
        raise ValueError(f"emformer_attention kernel does not take (B, H, Tq, Tk, dh) = {(b, h, tq, tk, dh)}: "
                         "Tq, Tk >= 32, dh a multiple of 8, Tq * Tk below about a million")
    if mask_bias.shape != (tq, tk) or key_bias.shape != (b, tk):
        raise ValueError(f"emformer_attention: mask_bias ({tq}, {tk}) and key_bias ({b}, {tk}) expected; got "
                         f"{tuple(mask_bias.shape)}, {tuple(key_bias.shape)}")
    for name, t in (("k", k), ("v", v), ("mask_bias", mask_bias), ("key_bias", key_bias)):
        if t.device != q.device:
            raise ValueError(f"emformer_attention: {name} must be on {q.device}; got {t.device}")


class EmformerAttentionFn(torch.autograd.Function):
    """K9 on CUDA tensors: the forward kernel, and the backward kernels from the saved
    output, row maximum and log row sum, both on the route :func:`kernel_route` names.
    The two mask factors get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask_bias, key_bias):
        _check(q, k, v, mask_bias, key_bias)
        b, h, tq, dh = q.shape
        tk = k.shape[2]
        route = kernel_route(q.dtype, tq, tk, dh)
        tma = route == "wgmma"
        q, k, v = (_kernel_view(t, tma) for t in (q, k, v))
        mask_bias = mask_bias.float().contiguous()
        key_bias = key_bias.float().contiguous()
        out = _time_major_empty(b, h, tq, dh, q)
        stats = torch.empty((2, b, h, tq), dtype=torch.float32, device=q.device)  # row maximum, log row sum
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(), key_bias.data_ptr(), out.data_ptr(),
                stats.data_ptr(), b, h, tq, tk, dh, _strides(q, k, v, out))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            if tma:
                err = _build.bind("attention", "emformer_attention_fwd_wgmma", _WGMMA_FWD_ARGTYPES)(*args, stream)
            else:
                fn = _build.bind("attention", "emformer_attention_fwd", _FWD_ARGTYPES)
                err = fn(*args, int(q.dtype == torch.bfloat16), stream)
        _build.check_launch(err, f"emformer_attention forward ({route})")
        launches["emformer_attention_fwd"] += 1
        route_launches[f"{route}_fwd"] += 1
        ctx.route = route
        ctx.save_for_backward(q, k, v, mask_bias, key_bias, out, stats)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, mask_bias, key_bias, out, stats = ctx.saved_tensors
        b, h, tq, dh = q.shape
        tk = k.shape[2]
        tma = ctx.route == "wgmma"
        grad_out = _kernel_view(grad_out.to(v.dtype), tma)
        dq = _time_major_empty(b, h, tq, dh, q)
        dk = _time_major_empty(b, h, tk, dh, k)
        dv = _time_major_empty(b, h, tk, dh, v)
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_bias.data_ptr(), key_bias.data_ptr(), out.data_ptr(),
                stats.data_ptr(), grad_out.data_ptr())
        tail = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, tq, tk, dh,
                _strides(q, k, v, out, grad_out, dq, dk, dv))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            if tma:  # delta is taken inside the one launch
                err = _build.bind("attention", "emformer_attention_bwd_wgmma", _WGMMA_BWD_ARGTYPES)(*head, *tail,
                                                                                                      stream)
            else:
                delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)  # rowsum(P * dO V^T)
                fn = _build.bind("attention", "emformer_attention_bwd", _BWD_ARGTYPES)
                err = fn(*head, delta.data_ptr(), *tail, int(q.dtype == torch.bfloat16), stream)
        _build.check_launch(err, f"emformer_attention backward ({ctx.route})")
        launches["emformer_attention_bwd"] += 1
        route_launches[f"{ctx.route}_bwd"] += 1
        return dq, dk, dv, None, None


def emformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask_bias: torch.Tensor,
                       key_bias: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T + mask_bias + key_bias) v`` with gradients to q, k and v.

    q (B, H, Tq, dh), already scaled by ``dh ** -0.5``; k, v (B, H, Tk, dh);
    mask_bias (Tq, Tk) additive mask shared by every batch entry and head
    (0 or a large finite negative); key_bias (B, Tk) additive bias of each
    batch entry's keys.  Returns (B, H, Tq, dh) in v's type.  CUDA tensors run
    kernel K9 (float32 or bfloat16, shapes of :func:`fused_attention_supported`;
    anything else raises); CPU tensors run :func:`emformer_attention_plain`.
    """
    if not q.is_cuda:
        return emformer_attention_plain(q, k, v, mask_bias, key_bias)
    return EmformerAttentionFn.apply(q, k, v, mask_bias, key_bias)
