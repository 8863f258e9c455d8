"""RNN Transducer losses (functional wrappers).

Same argument contract as ``audio_tpu.functional._rnnt``: ``blank < 0`` counts
from the end, ``clamp`` bounds the gradients, reductions none/mean/sum, the
``fused_log_softmax`` switch.  The DP and the analytic gradients live in
``audio_tpu_torch.ops.rnnt`` and ``audio_tpu_torch.ops.rnnt_pruned``.
"""

from __future__ import annotations

import torch

from ..ops.rnnt import rnnt_loss_core
from ..ops.rnnt_pruned import (
    get_rnnt_prune_ranges,
    prune_target_encodings,
    rnnt_loss_pruned_core,
    rnnt_loss_simple_core,
)

__all__ = [
    "rnnt_loss",
    "rnnt_loss_simple",
    "rnnt_loss_pruned",
    "get_rnnt_prune_ranges",
    "prune_target_encodings",
]


def _reduce(costs: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction not in ("none", "mean", "sum"):
        raise ValueError('reduction should be one of "none", "mean", or "sum"')
    if reduction == "mean":
        return costs.mean()
    if reduction == "sum":
        return costs.sum()
    return costs


def rnnt_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    logit_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
    blank: int = -1,
    clamp: float = -1,
    reduction: str = "mean",
    fused_log_softmax: bool = True,
) -> torch.Tensor:
    """Compute the RNN Transducer loss.

    Args:
        logits: (B, max_T, max_U+1, V) joiner output.
        targets: (B, max_U) zero-padded targets.
        logit_lengths / target_lengths: (B,) valid lengths.
        blank: blank label (negative = from the end).
        clamp: clamp gradients to [-clamp, clamp] when > 0.
        reduction: "none" | "mean" | "sum".
    """
    if reduction not in ("none", "mean", "sum"):
        raise ValueError('reduction should be one of "none", "mean", or "sum"')
    if blank < 0:
        blank = logits.shape[-1] + blank
    costs = rnnt_loss_core(logits, targets.int(), logit_lengths.int(), target_lengths.int(), blank, float(clamp),
                           fused_log_softmax)
    return _reduce(costs, reduction)


def rnnt_loss_simple(
    am: torch.Tensor,
    lm: torch.Tensor,
    targets: torch.Tensor,
    logit_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
    blank: int = -1,
    reduction: str = "mean",
):
    """Trivial-joiner ("simple") transducer loss and the pruning posteriors.

    Scores the additive joiner ``am[t, v] + lm[u, v]`` over the full (T, U+1)
    lattice with no (B, T, U, V) tensor (arXiv:2206.13236).

    Args:
        am: (B, T, V) encoder-side logits.
        lm: (B, U+1, V) predictor-side logits.
        targets / logit_lengths / target_lengths: as :func:`rnnt_loss`.
        blank: blank label (negative = from the end).

    Returns:
        ``(loss, posteriors)``: the reduced loss, and (B, T, U+1) lattice
        occupancies without gradient for :func:`get_rnnt_prune_ranges`.
    """
    if blank < 0:
        blank = am.shape[-1] + blank
    costs, post = rnnt_loss_simple_core(am, lm, targets.int(), logit_lengths.int(), target_lengths.int(), blank)
    return _reduce(costs, reduction), post


def rnnt_loss_pruned(
    logits: torch.Tensor,
    targets: torch.Tensor,
    ranges: torch.Tensor,
    logit_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
    blank: int = -1,
    clamp: float = -1,
    reduction: str = "mean",
    fused_log_softmax: bool = True,
) -> torch.Tensor:
    """Exact transducer loss on a banded (pruned) joiner lattice.

    ``logits`` is the (B, T, s, V) banded joiner output: the joiner evaluated
    only at the ``s`` target positions a frame that ``ranges`` gives (see
    :func:`get_rnnt_prune_ranges` and :func:`prune_target_encodings`), so the
    lattice and its gradient scale with s instead of U+1.  With ``s >= U+1``
    and ``ranges[b, t, j] = j`` it equals :func:`rnnt_loss`.
    """
    if blank < 0:
        blank = logits.shape[-1] + blank
    costs = rnnt_loss_pruned_core(logits, targets.int(), ranges.int(), logit_lengths.int(), target_lengths.int(),
                                  blank, float(clamp), fused_log_softmax)
    return _reduce(costs, reduction)
