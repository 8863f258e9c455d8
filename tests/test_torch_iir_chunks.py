"""Kernels K4's and K1's "chunked" routes on the CPU: their route rules, the plan, and the algebra.

The route runs chunks of 32 samples from zero state, carries the state into each
chunk by a scan over a pass of 32 chunks with the powers of the companion matrix
A, and adds each chunk's response to its incoming state (``csrc/iir_chunks.cuh``).
``chunk_plan`` (the tables, made in float64) is held against powers of A and the
scan's zero-input responses; a plain PyTorch emulation of chunk, carry and
fix-up in float32 against the TPU kernel ``iir_pallas`` in interpret mode,
forward and reversed, at 2e-5 + 1e-5 |ref| (the port's short-signal IIR
tolerance: both sides sum in float32 in another order).  K1 runs the same
recurrence behind a FIR stage over each pass, staged behind the samples of the
pass before it (``csrc/lfilter.cu``): its emulation is held against the TPU
kernel ``lfilter_pallas`` in interpret mode and against the JAX package's
``functional.lfilter``, at the same tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_tpu.functional import lfilter as jax_lfilter
from audio_tpu.ops.pallas_iir import iir_pallas, lfilter_pallas

from audio_tpu_torch.ops import cuda_iir
from audio_tpu_torch.ops.iir import CARRY_LEVELS, CHUNK, chunk_plan, companion_matrix, iir_scan

from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

LANES = 32  # chunks a pass: a warp's lanes


def _a_tail(seed, c, order):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal((c, order)) / np.arange(1, order + 1)).astype(np.float32)


@pytest.mark.parametrize("order,want", [(1, "chunked"), (2, "chunked"), (12, "chunked"), (16, "chunked"),
                                        (17, "serial"), (128, "serial")])
def test_kernel_route_on_both_sides_of_the_order_limit(order, want):
    assert cuda_iir.kernel_route(order) == want


def test_companion_matrix_moves_the_state_by_one_sample():
    a_tail = torch.tensor([[0.3, -0.2, 0.1]], dtype=torch.float64)
    s = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)  # y[t-1], y[t-2], y[t-3]
    nxt = companion_matrix(a_tail)[0] @ s
    assert torch.allclose(nxt, torch.tensor([-(0.3 * 0.5 - 0.2 * -1.0 + 0.1 * 2.0), 0.5, -1.0], dtype=torch.float64))


@pytest.mark.parametrize("order", [1, 2, 12, 16])
def test_chunk_plan_holds_the_carry_powers_and_the_zero_input_responses(order):
    a_tail = torch.from_numpy(_a_tail(order, 2, order)).double()
    plan = chunk_plan(a_tail)
    assert plan.dtype == torch.float32 and tuple(plan.shape) == (2, CARRY_LEVELS * order**2 + order * CHUNK)
    carry = plan[:, : CARRY_LEVELS * order**2].reshape(2, CARRY_LEVELS, order, order)
    g = plan[:, CARRY_LEVELS * order**2 :].reshape(2, order, CHUNK)
    a = companion_matrix(a_tail)
    for lvl in range(CARRY_LEVELS):
        want = torch.linalg.matrix_power(a, CHUNK * 2**lvl).float()
        torch.testing.assert_close(carry[:, lvl], want, atol=1e-6 * float(want.abs().max()) + 1e-30, rtol=1e-6)
    for j in range(order):  # the response to a unit state y[-1-j] and no input
        zi = torch.zeros((1, 2, order), dtype=torch.float64)
        zi[..., j] = 1.0
        want = iir_scan(torch.zeros((1, 2, CHUNK), dtype=torch.float64), a_tail, zi=zi)[0].float()
        torch.testing.assert_close(g[:, j], want, atol=1e-7, rtol=1e-6)


def chunked_emulation(x: torch.Tensor, a_tail: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The "chunked" route's arithmetic in float32: chunks of CHUNK samples from zero state, the
    carry scan over each pass of LANES chunks (Kogge-Stone, level d adding A^(CHUNK d) times the
    state d chunks back), then each chunk's fix-up with g; ``reverse`` runs it over the flipped
    signal, as the kernel does by index."""
    if reverse:
        return torch.flip(chunked_emulation(torch.flip(x, (-1,)), a_tail), (-1,))
    b, c, t = x.shape
    n = a_tail.shape[1]
    plan = chunk_plan(a_tail)
    carry = plan[:, : CARRY_LEVELS * n * n].reshape(c, CARRY_LEVELS, n, n)
    g = plan[:, CARRY_LEVELS * n * n :].reshape(c, n, CHUNK)
    span = LANES * CHUNK
    passes = -(-t // span)
    xs = torch.nn.functional.pad(x, (0, passes * span - t)).reshape(b, c, passes, LANES, CHUNK)
    a = a_tail[None, :, None, None, :]
    hist = torch.zeros((b, c, passes, LANES, n))  # newest first
    y0 = torch.empty_like(xs)
    for i in range(CHUNK):  # chunk: every chunk from zero state at once
        yi = xs[..., i] - (a * hist).sum(-1)
        hist = torch.cat([yi[..., None], hist[..., :-1]], dim=-1)
        y0[..., i] = yi
    s = torch.zeros((b, c, n))
    out = []
    for p in range(passes):
        v = hist[:, :, p].clone()  # (B, C, LANES, n): the chunks' end states from zero state
        v[:, :, 0] += torch.einsum("crk,bck->bcr", carry[:, 0], s)
        for lvl in range(CARRY_LEVELS):  # carry
            d = 2**lvl
            shifted = torch.einsum("crk,bclk->bclr", carry[:, lvl], v[:, :, :-d])
            v = torch.cat([v[:, :, :d], v[:, :, d:] + shifted], dim=2)
        incoming = torch.cat([s[:, :, None], v[:, :, :-1]], dim=2)
        out.append(y0[:, :, p] + torch.einsum("cji,bclj->bcli", g, incoming))  # fix-up
        s = v[:, :, -1]
    return torch.stack(out, dim=2).reshape(b, c, passes * span)[..., :t]


@pytest.mark.parametrize("order", [1, 2, 12, 16])
@pytest.mark.parametrize("t", [1, CHUNK - 1, CHUNK + 1, 3 * CHUNK + 5])
def test_chunked_arithmetic_matches_the_interpreted_tpu_kernel(order, t):
    rng = np.random.default_rng(100 * order + t)
    x = rng.standard_normal((3, 2, t)).astype(np.float32)
    a_tail = _a_tail(order + t, 2, order)
    for reverse in (False, True):
        xin = x[..., ::-1].copy() if reverse else x
        ref = np.asarray(iir_pallas(jnp.asarray(xin), jnp.asarray(a_tail), interpret=True))
        ref = ref[..., ::-1] if reverse else ref
        got = chunked_emulation(torch.from_numpy(x), torch.from_numpy(a_tail), reverse)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("order", [2, 16])
def test_chunked_arithmetic_carries_the_state_across_passes(order):
    """Past one pass of LANES chunks the state enters the next pass through lane 0."""
    t = 2 * LANES * CHUNK + 37
    rng = np.random.default_rng(order)
    x = rng.standard_normal((1, 2, t)).astype(np.float32)
    a_tail = _a_tail(order, 2, order)
    ref = np.asarray(iir_pallas(jnp.asarray(x), jnp.asarray(a_tail), interpret=True))
    got = chunked_emulation(torch.from_numpy(x), torch.from_numpy(a_tail))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)


# ------------------------------------------------------------------ K1
PASS = LANES * CHUNK  # samples a warp's pass


@pytest.mark.parametrize("pa,pb,want", [(2, 1, "chunked"), (3, 129, "chunked"), (17, 3, "chunked"),
                                        (17, 129, "chunked"), (18, 1, "serial"), (18, 17, "serial"),
                                        (129, 129, "serial")])
def test_lfilter_route_on_both_sides_of_the_order_limit(pa, pb, want):
    assert cuda_iir.lfilter_route(pa, pb) == want


def lfilter_chunked_emulation(x: torch.Tensor, a_norm: torch.Tensor, b_norm: torch.Tensor) -> torch.Tensor:
    """K1's "chunked" route in float32: per pass of PASS samples, the FIR stage over the pass staged
    behind the pb - 1 samples before it (the previous pass's last ones, zeros at the row's start), on
    the whole pass (samples past T are zeros, as the kernel stages them); then chunk, carry and
    fix-up on the FIR stage's output, which outputs past T do not reach."""
    b, c, t = x.shape
    pb = b_norm.shape[1]
    hist = pb - 1
    passes = -(-t // PASS)
    xs = torch.nn.functional.pad(x, (0, passes * PASS - t)).reshape(b, c, passes, PASS)
    before = x.new_zeros((b, c, hist))
    v = []
    for p in range(passes):
        staged = torch.cat([before, xs[:, :, p]], dim=-1)  # x[j] at staged[hist + j]
        vp = torch.zeros((b, c, PASS))
        for k in range(pb):
            vp = vp + b_norm[:, k, None] * staged[..., hist - k : hist - k + PASS]
        v.append(vp)
        before = staged[..., PASS:]
    return chunked_emulation(torch.cat(v, dim=-1), a_norm[:, 1:])[..., :t]


def _lfilter_coeffs(seed, c, order, pb):
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.ones((c, 1), np.float32), _a_tail(seed, c, order)], axis=1)
    b = (0.3 * rng.standard_normal((c, pb))).astype(np.float32)
    return a, b


def _padded(a, b):
    """(a, b) zero-padded to one length, as ``functional.lfilter`` takes them: the same filter."""
    taps = max(a.shape[1], b.shape[1])
    return tuple(np.pad(m, ((0, 0), (0, taps - m.shape[1]))) for m in (a, b))


@pytest.mark.parametrize("order", [1, 2, 8, 16])
@pytest.mark.parametrize("pb", [1, 3, 17])
@pytest.mark.parametrize("t", [31, 1000, 2100])
def test_lfilter_chunked_arithmetic_matches_the_interpreted_tpu_kernel_and_jax_lfilter(order, pb, t):
    """T below one chunk, inside one pass, and across two pass boundaries (the FIR history
    crosses them); the history also crosses chunk boundaries inside a pass."""
    rng = np.random.default_rng(1000 * order + 10 * pb + t)
    x = rng.standard_normal((2, 2, t)).astype(np.float32)
    a, b = _lfilter_coeffs(order + pb + t, 2, order, pb)
    got = lfilter_chunked_emulation(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(lfilter_pallas(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    ap, bp = _padded(a, b)
    ref = np.asarray(jax_lfilter(jnp.asarray(x), jnp.asarray(ap), jnp.asarray(bp), clamp=False))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_lfilter_chunked_arithmetic_carries_129_taps_across_chunks_and_passes():
    """pb - 1 = 128 samples of history: four chunks back inside a pass, and from one pass to the next."""
    t = 2 * PASS + 100
    x = np.random.default_rng(7).standard_normal((1, 2, t)).astype(np.float32)
    a, b = _lfilter_coeffs(7, 2, 2, 129)
    got = lfilter_chunked_emulation(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(lfilter_pallas(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
