"""CTC forced-alignment Viterbi DP.

Same contract as ``audio_tpu.ops.viterbi.viterbi_align``: batched over
streams, variable input and target lengths handled by freezing finished
lanes, ties broken toward "stay".  The state labels and the skip and validity
masks are built here; the DP and backtrack run in kernel K3 on CUDA and in
its plain version (the scan formulation) on the CPU, both in
``cuda_viterbi``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda_viterbi import viterbi_paths

__all__ = ["viterbi_align"]


def _state_labels(targets: torch.Tensor, blank: int, s: int) -> torch.Tensor:
    """labels (B, S): blank at even states, targets[i//2] at odd states."""
    i = torch.arange(s, device=targets.device)
    tok = targets[:, (i // 2).clamp(0, targets.shape[1] - 1)]
    return torch.where(i % 2 == 0, torch.full_like(tok, blank), tok)


def _state_masks(targets: torch.Tensor, target_lengths: torch.Tensor, s: int):
    """(state_valid, can_skip), each (B, S) bool."""
    b, l_max = targets.shape
    state_idx = torch.arange(s, device=targets.device)
    state_valid = state_idx[None, :] < (2 * target_lengths[:, None] + 1)
    # skip into odd state i (i >= 3) when its token differs from the previous one
    same_as_prev = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=targets.device), targets[:, 1:] == targets[:, :-1]], dim=1
    )
    odd = state_idx % 2 == 1
    can_skip = (odd & (state_idx >= 3))[None, :] & ~same_as_prev[:, (state_idx // 2).clamp(0, l_max - 1)]
    return state_valid, can_skip & state_valid


def viterbi_align(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    blank: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viterbi forced alignment over the CTC trellis.

    Args:
        log_probs: (B, T, C) log emission probabilities.
        targets: (B, L) target token ids (no blanks).
        input_lengths: (B,) valid frames per sequence (default: T).
        target_lengths: (B,) valid tokens per sequence (default: L).
        blank: blank token id.

    Returns:
        paths: (B, T) int32 aligned token id per frame (blank past length).
        scores: (B, T) log prob of the aligned token per frame (0 past length).
    """
    b, t_max, _ = log_probs.shape
    l_max = targets.shape[1]
    s = 2 * l_max + 1
    dev = log_probs.device
    if input_lengths is None:
        input_lengths = torch.full((b,), t_max, dtype=torch.int32, device=dev)
    if target_lengths is None:
        target_lengths = torch.full((b,), l_max, dtype=torch.int32, device=dev)
    input_lengths = input_lengths.to(device=dev, dtype=torch.int32)
    target_lengths = target_lengths.to(device=dev, dtype=torch.int32)
    targets = targets.to(dev)

    labels = _state_labels(targets, blank, s)
    state_valid, can_skip = _state_masks(targets, target_lengths, s)
    paths = viterbi_paths(log_probs, labels, can_skip, state_valid, input_lengths, 2 * target_lengths, blank)

    scores = log_probs.gather(2, paths.long()[..., None])[..., 0]
    frame_ok = torch.arange(t_max, device=dev)[None, :] < input_lengths[:, None]
    scores = torch.where(frame_ok, scores, torch.zeros_like(scores))
    return paths, scores
