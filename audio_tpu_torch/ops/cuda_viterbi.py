"""Kernel K3: the CTC forced-alignment Viterbi DP and backtrack.

CUDA C++ in ``csrc/viterbi.cu``, replacing the TPU kernel
``audio_tpu/ops/pallas_viterbi.py::viterbi_pallas_core``.  ``viterbi_paths``
launches it for a CUDA tensor and runs ``viterbi_paths_plain``, the plain
PyTorch version (the scan formulation of ``audio_tpu.ops.viterbi``), for a
CPU tensor.  ``launches`` counts the kernel's launches.

Semantics kept exactly: the -1e30 sentinel, ties broken stay > skip-1 >
skip-2, frames at t >= length frozen, the final state chosen from
{2L, 2L-1} with ``a_last > a_tok`` strictly, blank past the length.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["MAX_STATES", "viterbi_paths", "viterbi_paths_plain", "launches"]

NEG_INF = -1e30  # never -inf, so (-inf) - (-inf) cannot appear
# One thread per state in a block of at most 1024 threads.
MAX_STATES = 1024
# Backpointers stay in shared memory while the block's total fits this.
_SMEM_BUDGET = 48 * 1024

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def viterbi_paths_plain(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    can_skip: torch.Tensor,
    state_valid: torch.Tensor,
    input_lengths: torch.Tensor,
    s_last: torch.Tensor,
    blank: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K3: a scan over frames, then the backtrack."""
    b, t_max, _ = log_probs.shape
    s = labels.shape[1]
    labels = labels.long()
    emits = log_probs.gather(2, labels[:, None, :].expand(b, t_max, s))  # (B, T, S)
    neg = torch.full((), NEG_INF, dtype=log_probs.dtype, device=log_probs.device)
    state_idx = torch.arange(s, device=log_probs.device)
    alpha = torch.where((state_idx[None, :] < 2) & state_valid, emits[:, 0], neg)
    backs = [torch.zeros((b, s), dtype=torch.int8, device=log_probs.device)]
    for t in range(1, t_max):
        x0 = alpha
        x1 = F.pad(alpha, (1, 0), value=NEG_INF)[:, :-1]
        x2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=NEG_INF)[:, :-2], neg)
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
        ltr = torch.where(active, ltr - move, ltr)
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

    log_probs (B, T, V); labels (B, S) state token ids; can_skip and
    state_valid (B, S) bool; input_lengths (B,); s_last (B,) final blank state
    index.  A CUDA tensor runs kernel K3 (float32 log_probs, S <= 1024); a CPU
    tensor runs :func:`viterbi_paths_plain`.
    """
    global launches
    if not log_probs.is_cuda:
        return viterbi_paths_plain(log_probs, labels, can_skip, state_valid, input_lengths, s_last, blank)
    if log_probs.dim() != 3 or log_probs.dtype != torch.float32 or not log_probs.is_contiguous():
        raise ValueError(f"viterbi kernel takes contiguous float32 (B, T, V); got {log_probs.dtype} "
                         f"{tuple(log_probs.shape)}")
    b, t_max, v = log_probs.shape
    s = labels.shape[-1]
    if s > MAX_STATES:
        raise ValueError(f"viterbi kernel takes at most {MAX_STATES} states (2L+1); got {s}")
    dev = log_probs.device
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
    s_pad = -(-s // 32) * 32
    scratch = None
    if 2 * s_pad * 4 + t_max * s_pad > _SMEM_BUDGET:
        scratch = torch.empty((b, t_max, s_pad), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        fn = _build.bind("viterbi", "viterbi_f32", _ARGTYPES)
        err = fn(log_probs.data_ptr(), labels.data_ptr(), can_skip.data_ptr(), state_valid.data_ptr(),
                 lengths.data_ptr(), s_last.data_ptr(), paths.data_ptr(),
                 0 if scratch is None else scratch.data_ptr(), b, t_max, v, s, blank,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "viterbi")
    launches += 1
    return paths
