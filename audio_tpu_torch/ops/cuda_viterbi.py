"""Kernel K3: the CTC forced-alignment Viterbi DP and backtrack.

CUDA C++ in ``csrc/viterbi.cu``, replacing the TPU kernel
``audio_tpu/ops/pallas_viterbi.py::viterbi_pallas_core``.  ``viterbi_paths``
launches it for a CUDA tensor and runs ``viterbi_paths_plain``, the plain
PyTorch version (the scan formulation of ``audio_tpu.ops.viterbi``), for a
CPU tensor.  The kernel computes in the log-probabilities' own type (float32,
float64, bfloat16 or float16), as the JAX package's scan does: ``best + emit``
is rounded to that type each frame, and the -1e30 sentinel is cast to it
(-inf in float16).

Two routes, chosen by :func:`kernel_route` from the state count S = 2L+1:

* ``"warp"`` (S <= ``WARP_MAX_STATES``): a warp a stream, each lane holding
  ``warp_states_per_lane(S)`` consecutive states in registers; 2-bit
  backpointers in shared memory (in a global scratch for long inputs); a
  trellis with the CTC layout that ``ops/viterbi.py`` builds runs without the
  per-state tests that layout settles;
* ``"block"`` (any S): a block a stream, a thread a state, looped over the
  states past 1024 threads (the kernel's first design).

``launches`` counts the kernel's launches and ``route_launches`` each route's.
Semantics kept exactly: ties broken stay > skip-1 > skip-2, frames at t >=
length frozen, the final state chosen from {2L, 2L-1} with ``a_last > a_tok``
strictly, blank past the length, and a backtrack that an emission of -inf
steps off state 0 is held at state 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["DTYPES", "WARP_MAX_STATES", "kernel_route", "launches", "route_launches", "viterbi_paths",
           "viterbi_paths_plain", "warp_bp_on_chip", "warp_states_per_lane"]

NEG_INF = -1e30  # cast to the log-probabilities' type: -inf in float16, finite in the others
DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16)
_DTYPE_CODES = {dtype: i for i, dtype in enumerate(DTYPES)}  # csrc/viterbi.cu's dtype codes
# route "warp" keeps up to 8 states a lane in registers: 8 * 32 states
WARP_MAX_STATES = 256
# route "warp": a warp's backpointers stay in shared memory while they take at most this many bytes
_WARP_BP_BYTES = 8 * 1024
# route "block": the state front, then the backpointers, stay in shared memory while they fit this
_BLOCK_SMEM = 48 * 1024

launches = 0
route_launches = {"warp": 0, "block": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_WARP_ARGTYPES = [_I] + [_P] * 8 + [_I] * 5 + [_P]
_BLOCK_ARGTYPES = [_I] + [_P] * 9 + [_I] * 5 + [_P]


def kernel_route(s: int, dtype: torch.dtype) -> Optional[str]:
    """K3's route for ``s`` states (2L+1) in ``dtype``: ``"warp"`` up to ``WARP_MAX_STATES``,
    ``"block"`` past it; None for a type the kernel does not take."""
    if dtype not in DTYPES:
        return None
    return "warp" if s <= WARP_MAX_STATES else "block"


def warp_states_per_lane(s: int) -> int:
    """Route "warp": the states a lane holds, 4 up to 128 states, else 8."""
    return 4 if s <= 128 else 8


def _warp_word_bytes(s: int) -> int:
    """Route "warp": bytes of a lane's packed backpointers a frame (2 bits a state)."""
    return 1 if warp_states_per_lane(s) == 4 else 2


def warp_bp_on_chip(t: int, s: int) -> bool:
    """Route "warp": whether a stream's backpointers, T frames of 32 lane words, stay in shared memory."""
    return t * 32 * _warp_word_bytes(s) <= _WARP_BP_BYTES


def _neg(dtype: torch.dtype, device) -> torch.Tensor:
    """The sentinel in ``dtype``, rounded as the kernel and the JAX package round it (float16: -inf)."""
    return torch.tensor(NEG_INF, dtype=torch.float64).to(device=device, dtype=dtype)


def viterbi_paths_plain(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    can_skip: torch.Tensor,
    state_valid: torch.Tensor,
    input_lengths: torch.Tensor,
    s_last: torch.Tensor,
    blank: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K3: a scan over frames in the input's type, then the backtrack."""
    b, t_max, _ = log_probs.shape
    s = labels.shape[1]
    labels = labels.long()
    emits = log_probs.gather(2, labels[:, None, :].expand(b, t_max, s))  # (B, T, S)
    neg = _neg(log_probs.dtype, log_probs.device)
    pad = neg.expand(b, 2)
    state_idx = torch.arange(s, device=log_probs.device)
    alpha = torch.where((state_idx[None, :] < 2) & state_valid, emits[:, 0], neg)
    backs = [torch.zeros((b, s), dtype=torch.int8, device=log_probs.device)]
    for t in range(1, t_max):
        x0 = alpha
        x1 = torch.cat([pad[:, :1], alpha], dim=1)[:, :s]
        x2 = torch.where(can_skip, torch.cat([pad, alpha], dim=1)[:, :s], neg)
        stay = (x0 >= x1) & (x0 >= x2)
        back = torch.where(stay, 0, torch.where(x1 >= x2, 1, 2)).to(torch.int8)
        best = torch.maximum(x0, torch.maximum(x1, x2))
        new_alpha = torch.where(state_valid, best + emits[:, t], neg)
        active = (t < input_lengths)[:, None]
        alpha = torch.where(active, new_alpha, alpha)
        backs.append(torch.where(active, back, torch.zeros_like(back)))

    s_last = s_last.long().clamp(0, s - 1)
    s_tok = (s_last - 1).clamp(min=0)
    a_last = alpha.gather(1, s_last[:, None])[:, 0]
    a_tok = alpha.gather(1, s_tok[:, None])[:, 0]
    ltr = torch.where(a_last > a_tok, s_last, s_tok)
    paths = torch.empty((b, t_max), dtype=torch.int32, device=log_probs.device)
    for t in range(t_max - 1, -1, -1):
        lbl = labels.gather(1, ltr[:, None])[:, 0]
        move = backs[t].gather(1, ltr[:, None])[:, 0].long()
        active = t < input_lengths
        paths[:, t] = torch.where(active, lbl, blank).to(torch.int32)
        # only an emission of -inf can step off state 0: the walk stays there
        ltr = torch.where(active, (ltr - move).clamp(min=0), ltr)
    return paths


def viterbi_paths(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    can_skip: torch.Tensor,
    state_valid: torch.Tensor,
    input_lengths: torch.Tensor,
    s_last: torch.Tensor,
    blank: int = 0,
) -> torch.Tensor:
    """Viterbi paths (B, T) int32 over the CTC trellis.

    log_probs (B, T, V) in float32, float64, bfloat16 or float16, any layout;
    labels (B, S) state token ids; can_skip and state_valid (B, S) bool;
    input_lengths (B,); s_last (B,) final blank state index.  A CUDA tensor
    runs kernel K3 on the route :func:`kernel_route` names, any S; a CPU
    tensor runs :func:`viterbi_paths_plain`.
    """
    if not log_probs.is_cuda:
        return viterbi_paths_plain(log_probs, labels, can_skip, state_valid, input_lengths, s_last, blank)
    route = kernel_route(labels.shape[-1], log_probs.dtype)
    if route is None:
        raise TypeError(f"viterbi kernel takes float32, float64, bfloat16 or float16 log_probs; got {log_probs.dtype}")
    if log_probs.dim() != 3:
        raise ValueError(f"viterbi kernel takes (B, T, V) log_probs; got {tuple(log_probs.shape)}")
    return _launch(route, log_probs, labels, can_skip, state_valid, input_lengths, s_last, blank)


def _launch(route: str, log_probs, labels, can_skip, state_valid, input_lengths, s_last, blank: int = 0):
    """One launch of K3 on ``route`` (the wrapper's type check done): "warp" takes up to
    ``WARP_MAX_STATES`` states, "block" any S."""
    global launches
    b, t_max, v = log_probs.shape
    s = labels.shape[-1]
    dev = log_probs.device
    log_probs = log_probs.contiguous()
    labels = labels.to(device=dev, dtype=torch.int32).contiguous()
    can_skip = can_skip.to(device=dev, dtype=torch.bool).contiguous()
    state_valid = state_valid.to(device=dev, dtype=torch.bool).contiguous()
    lengths = input_lengths.to(device=dev, dtype=torch.int32).contiguous()
    s_last = s_last.to(device=dev, dtype=torch.int32).contiguous()
    for name, tensor, shape in (("labels", labels, (b, s)), ("can_skip", can_skip, (b, s)),
                                ("state_valid", state_valid, (b, s)), ("input_lengths", lengths, (b,)),
                                ("s_last", s_last, (b,))):
        if tensor.shape != shape:
            raise ValueError(f"{name} must have shape {shape}; got {tuple(tensor.shape)}")
    paths = torch.empty((b, t_max), dtype=torch.int32, device=dev)
    if paths.numel() == 0:
        return paths
    args = [log_probs.data_ptr(), labels.data_ptr(), can_skip.data_ptr(), state_valid.data_ptr(),
            lengths.data_ptr(), s_last.data_ptr(), paths.data_ptr()]
    code = _DTYPE_CODES[log_probs.dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "warp":
            if s > WARP_MAX_STATES:
                raise ValueError(f"viterbi route 'warp' takes at most {WARP_MAX_STATES} states; got {s}")
            bp = None
            if not warp_bp_on_chip(t_max, s):
                bp = torch.empty((b, t_max, 32 * _warp_word_bytes(s)), dtype=torch.uint8, device=dev)
            fn = _build.bind("viterbi", "viterbi_warp", _WARP_ARGTYPES)
            err = fn(code, *args, 0 if bp is None else bp.data_ptr(), b, t_max, v, s, blank, stream)
        else:
            s_pad = -(-s // 32) * 32
            front_bytes = 2 * s_pad * (8 if log_probs.dtype == torch.float64 else 4)
            front = bp = None
            if front_bytes > _BLOCK_SMEM:
                front = torch.empty((b, front_bytes), dtype=torch.uint8, device=dev)
            if front is not None or front_bytes + t_max * s_pad > _BLOCK_SMEM:
                bp = torch.empty((b, t_max, s_pad), dtype=torch.int8, device=dev)
            fn = _build.bind("viterbi", "viterbi_block", _BLOCK_ARGTYPES)
            err = fn(code, *args, 0 if bp is None else bp.data_ptr(), 0 if front is None else front.data_ptr(),
                     b, t_max, v, s, blank, stream)
    _build.check_launch(err, f"viterbi ({route})")
    launches += 1
    route_launches[route] += 1
    return paths
