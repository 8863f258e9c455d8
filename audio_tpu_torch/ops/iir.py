"""All-pole (IIR) recurrence engines: the plain PyTorch versions.

Same contract as ``audio_tpu.ops.iir``:

    y[t] = x[t] - sum_{k=1..order} a[k] * y[t-k]

* ``iir_scan`` runs the recurrence in time order.
* ``iir_blocked`` splits time into blocks of S samples and solves each block
  as one lower-triangular Toeplitz product with the filter's impulse
  response, after folding the incoming state into the first ``order`` inputs.
  Only the block-to-block carry is sequential.

``iir_plain`` chooses between them as the JAX package's ``iir_apply`` does off
the accelerator, and is kernel K4's plain version.  ``chunk_plan`` makes the
tables of K4's and K1's "chunked" routes (``csrc/iir_chunks.cuh``): for each channel the
powers of the companion matrix that carry the state from chunk to chunk, and
the chunks' zero-input responses.  These engines run on the
CPU in the port: on CUDA ``lfilter`` goes through kernel K1 and the all-pole
recurrence through kernel K4 (``cuda_iir``, which also holds ``iir_apply`` and
``lfilter_fused`` with their analytic gradients).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "CHUNK",
    "CARRY_LEVELS",
    "allpole_impulse_response",
    "chunk_plan",
    "companion_matrix",
    "fir_causal",
    "iir_blocked",
    "iir_plain",
    "iir_scan",
]

# Default block length of the blocked formulation.
_DEFAULT_BLOCK = 128
# At or below this many samples the scan is used.
_SCAN_CUTOFF = 256
# The "chunked" route: samples a chunk (a lane's), and the levels of the carry scan over the
# 32 chunks of a warp's pass (csrc/iir_chunks.cuh: kChunk, kLevels).
CHUNK = 32
CARRY_LEVELS = 5


def fir_causal(x: torch.Tensor, b_coeffs: torch.Tensor) -> torch.Tensor:
    """Causal FIR: y[t] = sum_k b[k] x[t-k].  x (B, C, T), b (C, K)."""
    k_taps = b_coeffs.shape[1]
    t = x.shape[-1]
    xp = F.pad(x, (k_taps - 1, 0))
    y = b_coeffs[:, 0, None] * x
    for k in range(1, k_taps):
        y = y + b_coeffs[:, k, None] * xp[..., k_taps - 1 - k : k_taps - 1 - k + t]
    return y


def allpole_impulse_response(a_tail: torch.Tensor, length: int) -> torch.Tensor:
    """Impulse response h (C, length) of 1 / (1 + sum a_k z^-k); h[0] = 1."""
    c, order = a_tail.shape
    h = [torch.ones((c,), dtype=a_tail.dtype, device=a_tail.device)]
    for t in range(1, length):
        m = min(order, t)
        past = torch.stack(h[t - m : t][::-1], dim=-1)  # (C, m): h[t-1], ..., h[t-m]
        h.append(-(a_tail[:, :m] * past).sum(-1))
    return torch.stack(h, dim=-1)


def iir_scan(x: torch.Tensor, a_tail: torch.Tensor, zi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Direct scan IIR.  x: (B, C, T), a_tail: (C, order) = [a1..aN], y: (B, C, T).

    ``zi`` (B, C, order) holds [y[-1], ..., y[-order]] (zeros if None).
    """
    b, c, t = x.shape
    order = a_tail.shape[-1]
    state = x.new_zeros((b, c, order)) if zi is None else zi
    ys = []
    for i in range(t):
        y_t = x[..., i] - (a_tail * state).sum(-1)
        state = torch.cat([y_t[..., None], state[..., :-1]], dim=-1)
        ys.append(y_t)
    return torch.stack(ys, dim=-1)


def _state_fold_matrix(a_tail: torch.Tensor) -> torch.Tensor:
    """M (C, order, order) with M[c, t, j] = a_c[t + j + 1] (0 beyond order)."""
    c, order = a_tail.shape
    idx = torch.arange(order, device=a_tail.device)
    k = idx[:, None] + idx[None, :]
    gathered = a_tail[:, k.clamp(max=order - 1)]
    return torch.where((k < order)[None], gathered, torch.zeros_like(gathered))


def iir_blocked(
    x: torch.Tensor,
    a_tail: torch.Tensor,
    zi: Optional[torch.Tensor] = None,
    block_size: int = _DEFAULT_BLOCK,
) -> torch.Tensor:
    """Blocked Toeplitz-product IIR.  Same contract as :func:`iir_scan`."""
    b, c, t = x.shape
    order = a_tail.shape[-1]
    s = block_size
    n_blocks = -(-t // s)
    t_pad = n_blocks * s

    h = allpole_impulse_response(a_tail, s)  # (C, S)
    idx = torch.arange(s, device=x.device)
    d = idx[:, None] - idx[None, :]
    toe = h[:, d.clamp(0, s - 1)]
    toe = torch.where((d >= 0)[None], toe, torch.zeros_like(toe))  # (C, S, S)
    fold = _state_fold_matrix(a_tail)  # (C, order, order)

    blocks = F.pad(x, (0, t_pad - t)).reshape(b, c, n_blocks, s)
    state = x.new_zeros((b, c, order)) if zi is None else zi
    ys = []
    for i in range(n_blocks):
        x_blk = blocks[:, :, i]
        corr = torch.einsum("ctj,bcj->bct", fold, state)
        v = torch.cat([x_blk[..., :order] - corr, x_blk[..., order:]], dim=-1)
        y_blk = torch.einsum("cij,bcj->bci", toe, v)
        state = torch.flip(y_blk[..., s - order :], (-1,))
        ys.append(y_blk)
    y = torch.stack(ys, dim=2).reshape(b, c, t_pad)
    return y[..., :t]


def iir_plain(x: torch.Tensor, a_tail: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K4: the all-pole recurrence with zero initial state.

    x (B, C, T), a_tail (C, order) = [a1..aN] -> y (B, C, T).  With ``reverse``
    the recurrence runs from the last sample to the first,
    y[t] = x[t] - sum_k a[k] y[t+k]: the filter applied to the flipped signal,
    flipped back.
    """
    if a_tail.shape[-1] == 0:
        return x
    if reverse:
        return torch.flip(iir_plain(torch.flip(x, (-1,)), a_tail), (-1,))
    if x.shape[-1] <= _SCAN_CUTOFF:
        return iir_scan(x, a_tail)
    return iir_blocked(x, a_tail)


def companion_matrix(a_tail: torch.Tensor) -> torch.Tensor:
    """A (C, order, order): the state s_t = (y[t], .., y[t-order+1]) moves as s_t = A s_{t-1} + x[t] e_0."""
    c, order = a_tail.shape
    a = torch.zeros((c, order, order), dtype=a_tail.dtype, device=a_tail.device)
    a[:, 0, :] = -a_tail
    a[:, 1:, :-1] += torch.eye(order - 1, dtype=a_tail.dtype, device=a_tail.device)
    return a


def chunk_plan(a_tail: torch.Tensor, chunk: int = CHUNK, levels: int = CARRY_LEVELS) -> torch.Tensor:
    """Tables of K4's and K1's "chunked" routes, (C, levels order^2 + order chunk) float32, on a_tail's device.

    For each channel, made in float64: the carry matrices A^(chunk d) for d = 1, 2, .., 2^(levels-1),
    row-major, then g (order, chunk), g[j, i] = (A^(i+1))[0, j], the response at sample i of a
    chunk to a unit state y[-1-j] and no input.
    """
    c, order = a_tail.shape
    a = companion_matrix(a_tail.double())
    powers = a[:, None]  # A^1 .. A^k, doubled until k >= chunk
    while powers.shape[1] < chunk:
        powers = torch.cat([powers, powers[:, -1:] @ powers], dim=1)
    powers = powers[:, :chunk]
    g = powers[:, :, 0, :].transpose(1, 2)  # (C, order, chunk)
    carry = [powers[:, -1]]
    for _ in range(levels - 1):
        carry.append(carry[-1] @ carry[-1])
    carry = torch.stack(carry, dim=1)  # (C, levels, order, order)
    return torch.cat([carry.reshape(c, -1), g.reshape(c, -1)], dim=1).float().contiguous()
