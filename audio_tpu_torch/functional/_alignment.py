"""CTC forced alignment (functional wrapper).

Same semantics as ``audio_tpu.functional._alignment``: ``forced_align``
validates the targets and runs the batched Viterbi of ``ops.viterbi``;
``merge_tokens`` turns a frame-level token sequence into ``TokenSpan``s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.viterbi import viterbi_align

__all__ = ["forced_align", "merge_tokens", "TokenSpan"]


def forced_align(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    blank: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Align a CTC label sequence to an emission.

    Args:
        log_probs: (B, T, C) log CTC emission probabilities.
        targets: (B, L) target sequence (must not contain ``blank``).
        input_lengths / target_lengths: optional (B,) valid lengths.
        blank: blank symbol index.

    Returns:
        (paths (B, T), scores (B, T)): per-frame aligned token ids and their
        log-prob scores.
    """
    # only tokens inside the valid region are checked (padding may be 0)
    if target_lengths is not None:
        lengths = torch.as_tensor(target_lengths, device=targets.device)
        valid = torch.arange(targets.shape[1], device=targets.device)[None, :] < lengths[:, None]
        tokens = targets[valid]
    else:
        tokens = targets.reshape(-1)
    if tokens.numel():
        has_blank, too_large = torch.stack([(tokens == blank).any(), tokens.max() >= log_probs.shape[-1]]).tolist()
        if has_blank:
            raise ValueError(f"targets Tensor shouldn't contain blank index. Found {targets}.")
        if too_large:
            raise ValueError("targets values must be less than the CTC dimension")
    return viterbi_align(log_probs, targets, input_lengths, target_lengths, blank)


@dataclass
class TokenSpan:
    """Token with time stamps and score; returned by :func:`merge_tokens`."""

    token: int
    start: int
    end: int
    score: float

    def __len__(self) -> int:
        return self.end - self.start


def _host(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def merge_tokens(tokens, scores, blank: int = 0) -> List[TokenSpan]:
    """Remove repeats and blanks from a CTC token sequence, yielding spans."""
    tokens = _host(tokens)
    scores = _host(scores)
    if tokens.ndim != 1 or scores.ndim != 1:
        raise ValueError("`tokens` and `scores` must be 1D Tensor.")
    if len(tokens) != len(scores):
        raise ValueError("`tokens` and `scores` must be the same length.")
    diff = np.diff(tokens, prepend=-1, append=-1)
    changes = np.nonzero(diff != 0)[0].tolist()
    spans = [
        TokenSpan(token=int(tokens[start]), start=start, end=end, score=float(scores[start:end].mean()))
        for start, end in zip(changes[:-1], changes[1:])
        if int(tokens[start]) != blank
    ]
    return spans
