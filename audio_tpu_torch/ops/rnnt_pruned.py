"""Pruned (banded) RNN-T loss.

Same construction and numerics as ``audio_tpu.ops.rnnt_pruned`` (Kuang et al.,
"Pruned RNN-T for fast, memory-efficient ASR training", arXiv:2206.13236):

1. ``rnnt_loss_simple_core`` scores a trivial joiner ``am[t, v] + lm[u, v]``,
   whose per-cell log-softmax denominator is one max-shifted product of
   exponentials over V, so the full-lattice DP needs no (B, T, U, V) tensor.
2. ``get_rnnt_prune_ranges`` turns that loss's lattice posteriors into a band
   of ``s`` consecutive target positions a frame (non-decreasing starts,
   adjacent rows overlap by at least one), in integer tensor ops only.
3. ``rnnt_loss_pruned_core`` runs the exact forward-backward DP on the band:
   only the (B, T, s, V) banded joiner output exists, read once through kernel
   K8 (``lattice_row_stats``) on CUDA, with the same row solve and one-pass
   analytic backward as :mod:`audio_tpu_torch.ops.rnnt`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .cuda_rnnt_lps import lattice_row_stats
from .rnnt import (
    _NEG_INF,
    _acc_dtype,
    _coeff_sums,
    _semiring_scan,
    lattice_grad,
    occupancy_grads,
    rnnt_loss_from_logprobs,
)

__all__ = [
    "rnnt_loss_simple_core",
    "get_rnnt_prune_ranges",
    "prune_target_encodings",
    "rnnt_loss_pruned_core",
]


# =========================================================================
# Simple (trivial-joiner) loss: full-lattice DP without the V axis
# =========================================================================
def _simple_lps(am: torch.Tensor, lm: torch.Tensor, targets: torch.Tensor, blank: int):
    """Per-cell blank and label log-probs of the trivial joiner am[t] + lm[u].

    am (B, T, V), lm (B, U+1, V) -> blank_lp (B, T, U+1), label_lp (B, T, U):
    the log-softmax over V of ``am[t] + lm[u]`` at blank and at targets[u],
    without the (B, T, U+1, V) sum: the denominator is a max-shifted product of
    exponentials.  Autograd differentiates this function; the max shifts are
    detached (their gradient contributions cancel exactly).
    """
    am = am.float()
    lm = lm.float()
    am_m = am.detach().max(dim=-1).values  # (B, T)
    lm_m = lm.detach().max(dim=-1).values  # (B, U+1)
    inner = torch.einsum("btv,buv->btu", torch.exp(am - am_m[..., None]), torch.exp(lm - lm_m[..., None]))
    denom = am_m[:, :, None] + lm_m[:, None, :] + torch.log(inner)

    blank_lp = am[:, :, blank][:, :, None] + lm[:, None, :, blank] - denom
    u = targets.shape[1]
    idx = targets.long()
    am_y = am.gather(2, idx[:, None, :].expand(-1, am.shape[1], -1))  # (B, T, U): am[b, t, targets[b, u]]
    lm_y = lm[:, :u, :].gather(2, idx[:, :, None])[..., 0]  # (B, U)
    label_lp = am_y + lm_y[:, None, :] - denom[:, :, :u]
    return blank_lp, label_lp


def _cell_posteriors(alphas, betas, logit_lengths, target_lengths):
    """P(path passes through (t, u)) from one alpha/beta pass, masked."""
    ll = betas[:, 0, 0][:, None, None]
    dev = alphas.device
    t_idx = torch.arange(alphas.shape[1], device=dev)[None, :, None]
    u_idx = torch.arange(alphas.shape[2], device=dev)[None, None, :]
    valid = (t_idx < logit_lengths[:, None, None]) & (u_idx <= target_lengths[:, None, None])
    return torch.where(valid, torch.exp(alphas + betas - ll), alphas.new_zeros(()))


class _LpsLossFn(torch.autograd.Function):
    """(costs (B,), posteriors (B, T, U+1)) from per-cell log-probs, analytic backward.

    The posteriors reuse the forward's alpha/beta pass and carry no gradient.
    """

    @staticmethod
    def forward(ctx, blank_lp, label_lp, logit_lengths, target_lengths):
        costs, alphas, betas = rnnt_loss_from_logprobs(blank_lp, label_lp, logit_lengths, target_lengths)
        post = _cell_posteriors(alphas, betas, logit_lengths, target_lengths)
        ctx.save_for_backward(blank_lp, label_lp, alphas, betas, logit_lengths, target_lengths)
        ctx.mark_non_differentiable(post)
        return costs, post

    @staticmethod
    def backward(ctx, g_costs, _g_post):
        blank_lp, label_lp, alphas, betas, logit_lengths, target_lengths = ctx.saved_tensors
        g_blank, g_label = occupancy_grads(blank_lp, label_lp, alphas, betas, logit_lengths, target_lengths)
        return g_blank * g_costs[:, None, None], g_label * g_costs[:, None, None], None, None


def rnnt_loss_simple_core(am: torch.Tensor, lm: torch.Tensor, targets: torch.Tensor, logit_lengths: torch.Tensor,
                          target_lengths: torch.Tensor, blank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trivial-joiner transducer loss and the lattice posteriors for pruning.

    Returns ``(costs (B,), posteriors (B, T, U+1))``; the posteriors are the
    probability that a path passes through each lattice cell, without
    gradient: the band-selection signal of :func:`get_rnnt_prune_ranges`.
    """
    blank_lp, label_lp = _simple_lps(am, lm, targets, blank)
    return _LpsLossFn.apply(blank_lp, label_lp, logit_lengths, target_lengths)


# =========================================================================
# Prune-range construction
# =========================================================================
def get_rnnt_prune_ranges(posteriors: torch.Tensor, logit_lengths: torch.Tensor, target_lengths: torch.Tensor,
                          s: int) -> torch.Tensor:
    """Per-frame bands of ``s`` consecutive target positions.

    posteriors: (B, T, U+1) lattice occupancies (from
    :func:`rnnt_loss_simple_core`).  Returns ``ranges`` (B, T, s) int32 of
    absolute u indices that meet the banded DP's contract:

    * ``ranges[b, t, j] = start[b, t] + j`` (consecutive),
    * ``start[b, 0] = 0`` (the DP's origin is in band),
    * ``start`` non-decreasing with ``start[t+1] - start[t] <= s - 1``
      (adjacent bands overlap by at least one, so blank moves connect),
    * the final band covers ``U_b``: ``start[b, T_b - 1] = max(0, U_b - s + 1)``.

    Feasibility requires ``(s - 1) * (T_b - 1) >= U_b - s + 1``.  Nothing is
    read on the host.
    """
    b, t_max, u1 = posteriors.shape
    dev = posteriors.device
    sm1 = s - 1
    logit_lengths, target_lengths = logit_lengths.long(), target_lengths.long()
    cap = torch.clamp(target_lengths + 1 - s, min=0)  # start <= max(0, U_b - s + 1)

    # best window start a frame: the first maximum of the sliding occupancy sum
    csum = F.pad(torch.cumsum(posteriors, dim=-1), (1, 0))  # (B, T, U+2), csum[..., k] = sum_{<k}
    w = max(u1 - s + 1, 1)
    hi = torch.clamp(torch.arange(w, device=dev) + s, max=u1)
    win = csum[:, :, hi] - csum[:, :, :w]
    best = win.max(dim=-1, keepdim=True).values
    first = torch.where(win == best, torch.arange(w, device=dev), w)
    raw = first.min(dim=-1).values  # ties to the lowest start, as argmax
    raw = torch.minimum(raw, cap[:, None])
    raw[:, 0] = 0

    # non-decreasing
    start = torch.cummax(raw, dim=1).values
    # step <= s - 1:  start[t] <- min_{k <= t} start[k] + (t - k)(s - 1)
    t_idx = torch.arange(t_max, device=dev)[None, :]
    start = torch.cummin(start - t_idx * sm1, dim=1).values + t_idx * sm1
    # reach max(0, U_b - s + 1) by t = T_b - 1, climbing at most s - 1 a frame
    steps_left = torch.clamp((logit_lengths - 1)[:, None] - t_idx, min=0)
    start = torch.maximum(start, torch.clamp(cap[:, None] - steps_left * sm1, min=0))
    return (start[:, :, None] + torch.arange(s, device=dev)[None, None, :]).int()


def prune_target_encodings(target_encodings: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """Gather predictor outputs into the band: (B, U+1, D), (B, T, s) -> (B, T, s, D).

    Positions past U (a band that reaches beyond the targets) read zeros, as
    the JAX package's one-hot product does.
    """
    b, u1, d = target_encodings.shape
    t_max, s = ranges.shape[1:]
    idx = ranges.long().reshape(b, t_max * s)
    inside = (idx >= 0) & (idx < u1)
    rows = target_encodings.gather(1, idx.clamp(0, u1 - 1)[:, :, None].expand(-1, -1, d))
    rows = rows * inside[:, :, None].to(rows.dtype)
    return rows.reshape(b, t_max, s, d)


# =========================================================================
# Banded exact DP + analytic backward in one pass
# =========================================================================
def _masked_band_lps(logits, targets, ranges, logit_lengths, target_lengths, blank, fused_log_softmax):
    """Banded blank and label log-probs with the validity masks applied.

    logits (B, T, S, V) in any float type.  Returns blank_lp, label_lp (B, T, S)
    in f32 with out-of-lattice cells (u > U_b or t >= T_b) at -1e30, lse
    (B, T, S) or None, and tgt_at (B, T, S), the label of each band slot.  No
    f32 copy of the band is made: on CUDA the three reads a row (lse, blank,
    label) are one pass of kernel K8.
    """
    b, t_max, s, v = logits.shape
    acc = _acc_dtype(logits.dtype)
    u_cnt = targets.shape[1]
    tgt_at = targets.long().gather(1, ranges.long().clamp(0, u_cnt - 1).reshape(b, t_max * s)).reshape(b, t_max, s)
    if fused_log_softmax and acc == torch.float32:
        lse, blank_raw, label_raw = lattice_row_stats(logits, tgt_at, blank)
        blank_lp = blank_raw - lse
        label_lp = label_raw - lse
    else:
        x = logits.to(acc)
        lse = torch.logsumexp(x, dim=-1) if fused_log_softmax else None
        blank_lp = x[..., blank]
        label_lp = x.gather(-1, tgt_at[..., None])[..., 0]
        if lse is not None:
            blank_lp, label_lp = blank_lp - lse, label_lp - lse

    t_ok = torch.arange(t_max, device=logits.device)[None, :, None] < logit_lengths[:, None, None]
    cell_ok = t_ok & (ranges <= target_lengths[:, None, None])
    label_ok = t_ok & (ranges < target_lengths[:, None, None])
    neg = blank_lp.new_full((), _NEG_INF)
    return torch.where(cell_ok, blank_lp, neg), torch.where(label_ok, label_lp, neg), lse, tgt_at


def _shift_rows(rows: torch.Tensor, shift: torch.Tensor, fill: float) -> torch.Tensor:
    """out[..., j] = rows[..., j + shift] (one shift a row), out of range -> fill."""
    s = rows.shape[-1]
    idx = torch.arange(s, device=rows.device) + shift[..., None]
    ok = (idx >= 0) & (idx < s)
    return torch.where(ok, rows.gather(-1, idx.clamp(0, s - 1)), rows.new_full((), fill))


def _banded_alphas(blank_lp, label_lp, starts, logit_lengths):
    """alpha (B, T, S) over the banded lattice (log-probs masked already)."""
    b, t_max, s = blank_lp.shape
    neg = blank_lp.new_full((), _NEG_INF)
    valid = blank_lp > _NEG_INF / 2
    # row 0 (start[0] == 0): alpha[0, j] = sum_{k<j} label_lp[0, k]
    alpha = F.pad(torch.cumsum(label_lp[:, 0, :-1], dim=-1), (1, 0))
    alpha = torch.where(valid[:, 0], alpha, neg)

    sums = _coeff_sums(F.pad(label_lp[:, :, :-1], (1, 0), value=_NEG_INF))  # coefficient of slot j: label[t, j-1]
    d = (starts[:, 1:] - starts[:, :-1]).long()  # the band's shift into row t + 1
    active = torch.arange(t_max, device=blank_lp.device)[None, :] < logit_lengths[:, None]

    rows = [alpha]
    for t in range(1, t_max):
        base = _shift_rows(alpha + blank_lp[:, t - 1], d[:, t - 1], _NEG_INF)
        row = _semiring_scan(base, sums[:, t])
        alpha = torch.where(active[:, t, None], torch.where(valid[:, t], row, neg), alpha)
        rows.append(alpha)
    return torch.stack(rows, dim=1)


def _banded_betas(blank_lp, label_lp, starts, logit_lengths, target_lengths):
    """beta (B, T, S); beta[:, 0, 0] is the log-likelihood (start[0] == 0)."""
    b, t_max, s = blank_lp.shape
    dev = blank_lp.device
    neg = blank_lp.new_full((), _NEG_INF)
    t_last = (logit_lengths - 1).long()
    batch = torch.arange(b, device=dev)
    j_idx = torch.arange(s, device=dev)[None, :]

    start_last = starts.long().gather(1, t_last[:, None])  # (B, 1)
    j_u = target_lengths.long()[:, None] - start_last  # (B, 1): the final cell's slot
    blank_row_last = blank_lp[batch, t_last]
    label_row_last = label_lp[batch, t_last]
    final_blank = blank_row_last.gather(1, j_u.clamp(0, s - 1))
    # suffix sums of the label moves over [j, j_u): masked slots count as 0
    label_row0 = torch.where(label_row_last > _NEG_INF / 2, label_row_last, torch.zeros_like(label_row_last))
    suffix = torch.flip(torch.cumsum(torch.flip(label_row0, (-1,)), dim=-1), (-1,))
    beta = torch.where((j_idx <= j_u) & (blank_row_last > _NEG_INF / 2), final_blank + suffix, neg)

    d = (starts[:, 1:] - starts[:, :-1]).long()  # d[t] = start[t+1] - start[t]
    # the recurrence runs down the slots, so it is solved on the flipped axis
    sums_r = _coeff_sums(torch.flip(label_lp, (-1,)))
    valid = blank_lp > _NEG_INF / 2
    rows = [beta] * t_max
    for t in range(t_max - 2, -1, -1):
        base = _shift_rows(beta, -d[:, t], _NEG_INF) + blank_lp[:, t]
        row = torch.flip(_semiring_scan(torch.flip(base, (-1,)), sums_r[:, t]), (-1,))
        beta = torch.where((t < t_last)[:, None], torch.where(valid[:, t], row, neg), beta)
        rows[t] = beta
    return torch.stack(rows, dim=1)


def _pruned_forward(logits, targets, ranges, logit_lengths, target_lengths, blank, fused_log_softmax):
    blank_lp, label_lp, lse, tgt_at = _masked_band_lps(
        logits, targets, ranges, logit_lengths, target_lengths, blank, fused_log_softmax)
    starts = ranges[:, :, 0]
    alphas = _banded_alphas(blank_lp, label_lp, starts, logit_lengths)
    betas = _banded_betas(blank_lp, label_lp, starts, logit_lengths, target_lengths)
    # the DP's origin (0, 0) must be in band; a range set that cannot be walked (a band too
    # narrow to climb from 0 to U_b in T_b frames) fails loudly with +inf
    costs = torch.where(starts[:, 0] == 0, -betas[:, 0, 0], betas.new_full((), float("inf")))
    return costs, blank_lp, label_lp, lse, tgt_at, alphas, betas


class _PrunedLossFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, ranges, logit_lengths, target_lengths, blank, clamp, fused_log_softmax):
        costs, blank_lp, label_lp, lse, tgt_at, alphas, betas = _pruned_forward(
            logits, targets, ranges, logit_lengths, target_lengths, blank, fused_log_softmax)
        # the masked blank and label log-probs and tgt_at ride along ((B, T, S) each), so
        # the backward reads the band only in its one elementwise pass
        ctx.save_for_backward(logits, ranges, logit_lengths, target_lengths, lse, blank_lp, label_lp, tgt_at,
                              alphas, betas)
        ctx.config = (blank, clamp)
        return costs.to(_acc_dtype(logits.dtype))

    @staticmethod
    def backward(ctx, g):
        (logits, ranges, logit_lengths, target_lengths, lse, blank_lp, label_lp, tgt_at, alphas,
         betas) = ctx.saved_tensors
        blank, clamp = ctx.config
        b, t_max, s, v = logits.shape
        dev = logits.device
        ll = betas[:, 0, 0][:, None, None]
        zero = betas.new_zeros(())
        neg = betas.new_full((), _NEG_INF)

        t_idx = torch.arange(t_max, device=dev)[None, :, None]
        t_len = logit_lengths[:, None, None]
        u_len = target_lengths[:, None, None]
        t_ok = t_idx < t_len
        cell_ok = t_ok & (ranges <= u_len)
        label_ok = t_ok & (ranges < u_len)
        starts = ranges[:, :, 0]

        # blank move (t, j) -> (t+1, j - d[t]); it ends the lattice at the final cell
        d = F.pad(starts[:, 1:] - starts[:, :-1], (0, 1)).long()  # (B, T)
        beta_next = torch.cat([betas[:, 1:], torch.full_like(betas[:, :1], _NEG_INF)], dim=1)
        beta_shifted = _shift_rows(beta_next, -d, _NEG_INF)
        is_final = (t_idx == t_len - 1) & (ranges == u_len)
        beta_after_blank = torch.where(is_final, zero, torch.where(t_idx < t_len - 1, beta_shifted, neg))
        g_blank = -torch.exp(alphas + blank_lp + beta_after_blank - ll)
        g_blank = torch.where(cell_ok, g_blank, zero)

        # label move (t, j) -> (t, j+1): the last band slot has no successor in band
        beta_jp1 = torch.cat([betas[:, :, 1:], torch.full_like(betas[:, :, :1], _NEG_INF)], dim=2)
        g_label = -torch.exp(alphas + label_lp + beta_jp1 - ll)
        g_label = torch.where(label_ok, g_label, zero)

        grad = lattice_grad(logits, lse, g_blank, g_label, tgt_at, blank, clamp, g)
        return grad, None, None, None, None, None, None, None


def rnnt_loss_pruned_core(logits: torch.Tensor, targets: torch.Tensor, ranges: torch.Tensor,
                          logit_lengths: torch.Tensor, target_lengths: torch.Tensor, blank: int, clamp: float,
                          fused_log_softmax: bool = True) -> torch.Tensor:
    """Per-sequence pruned transducer costs (B,), analytic backward.

    logits: (B, T, s, V) banded joiner output, where slot (t, j) scores the
    lattice cell (t, ranges[b, t, j]); ranges as :func:`get_rnnt_prune_ranges`
    makes them (or any set that meets its contract).
    """
    return _PrunedLossFn.apply(logits, targets, ranges, logit_lengths, target_lengths, blank, clamp,
                               fused_log_softmax)
