"""RNN-T (transducer) loss: forward-backward DP with analytic gradients.

Same formulation and numerics as ``audio_tpu.ops.rnnt``.  For each row t the
alpha recurrence over u,

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + label[t, u-1]),

is a first-order linear recurrence in the (log, +) semiring.  The JAX package
solves it with an associative scan; here ``torch.logcumsumexp`` solves the same
recurrence: with C the running sum of the label coefficients,
y[u] = C[u] + logcumsumexp(base - C)[u].  The DP is a Python loop over the T
rows, each a handful of (B, U+1) tensor ops.

``rnnt_loss_core`` is a ``torch.autograd.Function``: its forward reads the
(B, T, U+1, V) lattice once, through kernel K8 (``lattice_row_stats``) for a
CUDA tensor and its plain version for a CPU tensor; its backward writes the
gradient in one pass over the lattice, in row blocks, so that no f32 copy of a
bf16 lattice is ever held whole.  The DP runs in f32 whatever the logits' type.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .cuda_rnnt_lps import lattice_row_stats

__all__ = [
    "lattice_grad",
    "occupancy_grads",
    "rnnt_alphas",
    "rnnt_betas",
    "rnnt_loss_core",
    "rnnt_loss_from_logprobs",
]

_NEG_INF = -1e30

# Lattice elements whose f32 gradient the backward holds at a time (256 MB).
_GRAD_BLOCK_ELEMS = 1 << 26


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _coeff_sums(coeff: torch.Tensor) -> torch.Tensor:
    """Running sums C of the coefficients of :func:`_semiring_scan` along the last axis.

    coeff[..., 0] is unused and counts as 0.  A masked coefficient (below
    -1e29) cuts the chain; it counts as 0 too, which leaves every cell after
    the cut right as long as the cells before it carry a masked ``base``, as
    the out-of-lattice cells of every caller do.
    """
    coeff = torch.where(coeff < _NEG_INF / 10, torch.zeros_like(coeff), coeff)
    coeff = torch.cat([torch.zeros_like(coeff[..., :1]), coeff[..., 1:]], dim=-1)
    return torch.cumsum(coeff, dim=-1)


def _semiring_scan(base: torch.Tensor, coeff_sums: torch.Tensor) -> torch.Tensor:
    """Solve y[u] = logaddexp(base[u], y[u-1] + coeff[u]) along the last axis, y[0] = base[0],
    given ``coeff_sums = _coeff_sums(coeff)``."""
    return coeff_sums + torch.logcumsumexp(base - coeff_sums, dim=-1)


def rnnt_alphas(blank_lp: torch.Tensor, label_lp: torch.Tensor, logit_lengths: torch.Tensor,
                target_lengths: torch.Tensor) -> torch.Tensor:
    """Forward variables alpha (B, T, U+1).

    blank_lp: (B, T, U+1) log prob of blank at (t, u);
    label_lp: (B, T, U) log prob of emitting target u+1 at (t, u).
    Rows t >= T_b repeat row T_b - 1; cells u > U_b hold -1e30.
    """
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    valid_u = torch.arange(u1, device=dev)[None] <= target_lengths[:, None]
    neg = blank_lp.new_full((), _NEG_INF)

    # alpha[0, u] = sum_{k<u} label[0, k]
    alpha = F.pad(torch.cumsum(label_lp[:, 0, :], dim=-1), (1, 0))
    alpha = torch.where(valid_u, alpha, neg)
    sums = _coeff_sums(F.pad(label_lp, (1, 0), value=_NEG_INF))  # coefficient of (t, u): label[t, u-1]
    active = torch.arange(t_max, device=dev)[None, :] < logit_lengths[:, None]  # (B, T)

    rows = [alpha]
    for t in range(1, t_max):
        row = _semiring_scan(alpha + blank_lp[:, t - 1], sums[:, t])  # the horizontal move, then the vertical ones
        alpha = torch.where(active[:, t, None], torch.where(valid_u, row, neg), alpha)
        rows.append(alpha)
    return torch.stack(rows, dim=1)


def rnnt_betas(blank_lp: torch.Tensor, label_lp: torch.Tensor, logit_lengths: torch.Tensor,
               target_lengths: torch.Tensor) -> torch.Tensor:
    """Backward variables beta (B, T, U+1); beta[:, 0, 0] is the log-likelihood.

    beta[t, u] = logaddexp(beta[t+1, u] + blank[t, u], beta[t, u+1] + label[t, u]),
    beta[T_b - 1, U_b] = blank[T_b - 1, U_b].  Rows t > T_b - 1 repeat row T_b - 1.
    """
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    u_idx = torch.arange(u1, device=dev)
    t_last = (logit_lengths - 1).long()
    tl = target_lengths.long()
    valid_u = u_idx[None] <= tl[:, None]
    neg = blank_lp.new_full((), _NEG_INF)
    batch = torch.arange(b, device=dev)

    # row T_b - 1: beta[u] = blank[T_b - 1, U_b] + sum_{k >= u} label[T_b - 1, k]
    blank_last = blank_lp[batch, t_last]  # (B, U+1)
    label_last = label_lp[batch, t_last]  # (B, U)
    final_blank = blank_last.gather(1, tl[:, None])
    label_masked = torch.where(u_idx[None, : u1 - 1] < tl[:, None], label_last, torch.zeros_like(label_last))
    suffix = F.pad(torch.flip(torch.cumsum(torch.flip(label_masked, (-1,)), dim=-1), (-1,)), (0, 1))
    beta = torch.where(valid_u, final_blank + suffix, neg)

    # the recurrence runs down u, so it is solved on the flipped axis
    blank_r = torch.flip(blank_lp, (-1,))
    sums_r = _coeff_sums(torch.flip(F.pad(label_lp, (0, 1), value=_NEG_INF), (-1,)))
    valid_r = torch.flip(valid_u, (-1,))
    beta_r = torch.flip(beta, (-1,))
    rows = [beta_r] * t_max
    for t in range(t_max - 2, -1, -1):
        row = _semiring_scan(beta_r + blank_r[:, t], sums_r[:, t])
        beta_r = torch.where((t < t_last)[:, None], torch.where(valid_r, row, neg), beta_r)
        rows[t] = beta_r
    return torch.flip(torch.stack(rows, dim=1), (-1,))


def rnnt_loss_from_logprobs(blank_lp: torch.Tensor, label_lp: torch.Tensor, logit_lengths: torch.Tensor,
                            target_lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (costs (B,), alphas, betas); cost = -log P(y | x)."""
    alphas = rnnt_alphas(blank_lp, label_lp, logit_lengths, target_lengths)
    betas = rnnt_betas(blank_lp, label_lp, logit_lengths, target_lengths)
    return -betas[:, 0, 0], alphas, betas


def _gather_lps_lazy(logits: torch.Tensor, targets: torch.Tensor, blank: int, fused_log_softmax: bool):
    """(blank_lp, label_lp, lse) without a normalized copy of the (B, T, U+1, V) lattice.

    log p = x - lse, so only the blank and label entries of each row are
    normalized.  Math in f32 whatever the logits' type (f64 stays f64).  With
    ``fused_log_softmax=False`` the inputs are log-probs already and lse is None.
    """
    u = targets.shape[1]
    acc = _acc_dtype(logits.dtype)
    if fused_log_softmax and acc == torch.float32:
        # one pass over the lattice for lse, blank and label: kernel K8 on CUDA
        tgt_rows = F.pad(targets, (0, 1))[:, None, :].expand(logits.shape[:-1])  # row U is unused
        lse, blank_raw, label_full = lattice_row_stats(logits, tgt_rows, blank)
        return blank_raw - lse, (label_full - lse)[:, :, :u], lse
    x = logits.to(acc)
    blank_raw = x[..., blank]
    label_idx = targets.long()[:, None, :, None].expand(x.shape[0], x.shape[1], u, 1)
    label_raw = x[:, :, :u, :].gather(-1, label_idx)[..., 0]
    if not fused_log_softmax:
        return blank_raw, label_raw, None
    lse = torch.logsumexp(x, dim=-1)
    return blank_raw - lse, label_raw - lse[:, :, :u], lse


def occupancy_grads(blank_lp, label_lp, alphas, betas, logit_lengths, target_lengths):
    """Analytic d(-ll)/d(blank_lp, label_lp): the negative lattice occupancies.

    Shared by the full loss's backward and the log-prob-level losses of
    :mod:`audio_tpu_torch.ops.rnnt_pruned`.
    """
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    u_max = u1 - 1
    ll = betas[:, 0, 0][:, None, None]
    t_idx = torch.arange(t_max, device=dev)[None, :, None]
    u_idx = torch.arange(u1, device=dev)[None, None, :]
    t_len = logit_lengths[:, None, None]
    u_len = target_lengths[:, None, None]
    zero = blank_lp.new_zeros(())
    neg = blank_lp.new_full((), _NEG_INF)

    # d(-ll)/d blank_lp[t,u] = -exp(alpha[t,u] + blank[t,u] + beta[t+1,u] - ll); the blank move
    # exists only for t + 1 < T_b, and at the final cell (T_b - 1, U_b) it ends the lattice (beta = 0)
    beta_tp1 = torch.cat([betas[:, 1:], torch.full_like(betas[:, :1], _NEG_INF)], dim=1)
    is_final = (t_idx == t_len - 1) & (u_idx == u_len)
    beta_after_blank = torch.where(is_final, zero, torch.where(t_idx < t_len - 1, beta_tp1, neg))
    g_blank = -torch.exp(alphas + blank_lp + beta_after_blank - ll)
    g_blank = torch.where((t_idx < t_len) & (u_idx <= u_len), g_blank, zero)

    # d(-ll)/d label_lp[t,u] = -exp(alpha[t,u] + label[t,u] + beta[t,u+1] - ll)
    g_label = -torch.exp(alphas[:, :, :u_max] + label_lp + betas[:, :, 1:] - ll)
    g_label = torch.where((t_idx < t_len) & (u_idx[..., :u_max] < u_len), g_label, zero)
    return g_blank, g_label


def lattice_grad(logits: torch.Tensor, lse: Optional[torch.Tensor], g_blank: torch.Tensor, g_label: torch.Tensor,
                 tgt: torch.Tensor, blank: int, clamp: float, g: torch.Tensor) -> torch.Tensor:
    """The gradient of the costs with respect to a (B, T, S, V) lattice, in logits' type.

    g_blank, g_label (B, T, S): gradients with respect to the blank and label
    log-probs of each row; tgt (B, T, S): each row's label; lse (B, T, S) the
    rows' logsumexp, or None where the lattice holds log-probs already;
    g (B,): the cotangent of the costs.  Per row the gradient with respect
    to the log-probs has two entries, so the chain through log_softmax is
    ``grad_lp - softmax(x) * (g_blank + g_label)`` with softmax = exp(x - lse):
    one elementwise pass that reads the logits and writes the gradient.  The
    pass goes by blocks of rows, in f32, so that the f32 softmax is never held
    for the whole lattice.
    """
    v = logits.shape[-1]
    acc = _acc_dtype(logits.dtype)
    x2 = logits.reshape(-1, v)
    out = torch.empty_like(x2)
    n = x2.shape[0]
    g_blank, g_label = g_blank.reshape(n, 1).to(acc), g_label.reshape(n, 1).to(acc)
    tgt = tgt.reshape(n, 1).long()
    g_rows = g.to(acc)[:, None].expand(g.shape[0], n // g.shape[0]).reshape(n, 1)
    if lse is not None:
        lse = lse.reshape(n, 1)
        neg_sum = -(g_blank + g_label)
    step = max(1, _GRAD_BLOCK_ELEMS // v)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        if lse is not None:
            grad = x2[r0:r1].to(acc, copy=True).sub_(lse[r0:r1]).exp_().mul_(neg_sum[r0:r1])
        else:
            grad = torch.zeros((r1 - r0, v), dtype=acc, device=logits.device)
        grad[:, blank] += g_blank[r0:r1, 0]
        grad.scatter_add_(1, tgt[r0:r1], g_label[r0:r1])
        if clamp > 0:
            grad.clamp_(-clamp, clamp)
        out[r0:r1] = grad.mul_(g_rows[r0:r1])
    return out.reshape(logits.shape)


class _RNNTLossFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, logit_lengths, target_lengths, blank, clamp, fused_log_softmax):
        blank_lp, label_lp, lse = _gather_lps_lazy(logits, targets, blank, fused_log_softmax)
        costs, alphas, betas = rnnt_loss_from_logprobs(blank_lp, label_lp, logit_lengths, target_lengths)
        # the blank and label log-probs ride along ((B, T, U+1) each, V times smaller than
        # the lattice), so the backward reads the lattice only in its one elementwise pass
        ctx.save_for_backward(logits, targets, logit_lengths, target_lengths, alphas, betas, lse, blank_lp, label_lp)
        ctx.config = (blank, clamp)
        return costs.to(_acc_dtype(logits.dtype))

    @staticmethod
    def backward(ctx, g):
        logits, targets, logit_lengths, target_lengths, alphas, betas, lse, blank_lp, label_lp = ctx.saved_tensors
        blank, clamp = ctx.config
        g_blank, g_label = occupancy_grads(blank_lp, label_lp, alphas, betas, logit_lengths, target_lengths)
        tgt_rows = F.pad(targets, (0, 1))[:, None, :].expand(logits.shape[:-1])
        grad = lattice_grad(logits, lse, g_blank, F.pad(g_label, (0, 1)), tgt_rows, blank, clamp, g)
        return grad, None, None, None, None, None, None


def rnnt_loss_core(logits: torch.Tensor, targets: torch.Tensor, logit_lengths: torch.Tensor,
                   target_lengths: torch.Tensor, blank: int, clamp: float,
                   fused_log_softmax: bool = True) -> torch.Tensor:
    """Per-sequence transducer costs (B,) with analytic gradients.

    logits: (B, T, U+1, V) joiner output; targets: (B, U).
    """
    return _RNNTLossFn.apply(logits, targets, logit_lengths, target_lengths, blank, clamp, fused_log_softmax)
