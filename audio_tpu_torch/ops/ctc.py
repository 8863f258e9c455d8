"""CTC loss and greedy decoding, on the device of the emissions.

Same semantics as ``audio_tpu.ops.ctc``.  The loss runs the forward
recurrence of the CTC trellis in the log semiring (logaddexp where the
Viterbi aligner takes a maximum) over the whole (B, S) state front a frame,
in a Python loop over the frames, and autograd differentiates it.
Unreachable states hold -1e30, not -inf, so an infeasible target gives a
loss near 1e30 where ``torch.nn.functional.ctc_loss`` gives inf; with
``zero_infinity`` a loss at or past 1e29 becomes 0, as the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["ctc_loss", "ctc_greedy_decode"]

_NEG_INF = -1e30


def _state_labels(targets: torch.Tensor, blank: int, s: int) -> torch.Tensor:
    i = torch.arange(s, device=targets.device)
    tok = targets[:, torch.clamp(i // 2, 0, targets.shape[1] - 1)]
    return torch.where(i % 2 == 0, torch.full_like(tok, blank), tok)


def _shift(alpha: torch.Tensor, k: int) -> torch.Tensor:
    """alpha moved ``k`` states up, -1e30 in the states it leaves."""
    return F.pad(alpha, (k, 0), value=_NEG_INF)[:, :-k]


def ctc_loss(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    blank: int = 0,
    reduction: str = "mean",
    zero_infinity: bool = False,
) -> torch.Tensor:
    """Connectionist Temporal Classification loss.

    Args:
        log_probs: (B, T, C) log-softmaxed emissions.
        targets: (B, L) labels (no blanks).
        input_lengths / target_lengths: (B,) valid lengths.
        reduction: "none" | "mean" | "sum".  "mean" divides each loss by its
            target length then averages (torch.nn.CTCLoss semantics).
    """
    b, t_max, _ = log_probs.shape
    l_max = targets.shape[1]
    s = 2 * l_max + 1
    dev = log_probs.device
    targets = targets.to(device=dev, dtype=torch.int64)
    if input_lengths is None:
        input_lengths = torch.full((b,), t_max, dtype=torch.int64, device=dev)
    if target_lengths is None:
        target_lengths = torch.full((b,), l_max, dtype=torch.int64, device=dev)
    input_lengths = input_lengths.to(device=dev, dtype=torch.int64)
    target_lengths = target_lengths.to(device=dev, dtype=torch.int64)

    labels = _state_labels(targets, blank, s)  # (B, S)
    state_idx = torch.arange(s, device=dev)
    state_valid = state_idx[None, :] < (2 * target_lengths[:, None] + 1)
    same_as_prev = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev), targets[:, 1:] == targets[:, :-1]],
                             dim=1)
    odd = state_idx % 2 == 1
    can_skip = (odd[None, :] & (state_idx[None, :] >= 3)
                & ~same_as_prev[:, torch.clamp(state_idx // 2, 0, l_max - 1)] & state_valid)

    emits = torch.gather(log_probs, 2, labels[:, None, :].expand(b, t_max, s))  # (B, T, S)
    neg = torch.tensor(_NEG_INF, dtype=log_probs.dtype, device=dev)
    alpha = torch.where(state_idx[None, :] < 2, emits[:, 0], neg)
    alpha = torch.where(state_valid, alpha, neg)
    for t in range(1, t_max):
        x2 = torch.where(can_skip, _shift(alpha, 2), neg)
        tot = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1)), x2)
        new_alpha = torch.where(state_valid, tot + emits[:, t], neg)
        alpha = torch.where((t < input_lengths)[:, None], new_alpha, alpha)

    s_last = 2 * target_lengths
    a_blank = torch.gather(alpha, 1, s_last[:, None])[:, 0]
    a_tok = torch.gather(alpha, 1, torch.clamp(s_last - 1, min=0)[:, None])[:, 0]
    a_tok = torch.where(target_lengths > 0, a_tok, neg)
    losses = -torch.logaddexp(a_blank, a_tok)
    if zero_infinity:
        losses = torch.where(torch.isfinite(losses) & (losses < 1e29), losses, torch.zeros_like(losses))
    if reduction == "mean":
        return torch.mean(losses / torch.clamp(target_lengths, min=1))
    if reduction == "sum":
        return torch.sum(losses)
    return losses


def ctc_greedy_decode(log_probs: torch.Tensor, lengths: Optional[torch.Tensor] = None, blank: int = 0):
    """Best-path decode: argmax per frame, collapse repeats, drop blanks.

    Returns (tokens (B, T) padded with -1, counts (B,)).
    """
    b, t_max, _ = log_probs.shape
    dev = log_probs.device
    if lengths is None:
        lengths = torch.full((b,), t_max, dtype=torch.int64, device=dev)
    lengths = lengths.to(dev)
    best = torch.argmax(log_probs, dim=-1)  # (B, T), the first index of a maximum
    prev = F.pad(best, (1, 0), value=-1)[:, :-1]
    frames = torch.arange(t_max, device=dev)[None, :]
    valid = (best != blank) & (best != prev) & (frames < lengths[:, None])
    # compact: stable sort by (not valid), keeping the order of the valid entries
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    tokens = torch.gather(best, 1, order)
    counts = valid.sum(dim=1)
    tokens = torch.where(frames < counts[:, None], tokens, torch.full_like(tokens, -1))
    return tokens, counts
