"""The port's transducer loss against ``audio_tpu.functional.rnnt_loss``.

The same numpy logits go through both; the JAX side reads the lattice through
its plain formulation on the CPU, the port through kernel K8's plain version.
Tolerances: costs rtol = atol = 1e-4 (tests/functional/test_rnnt.py), gradients
with respect to the logits atol 1e-5 + rtol 1e-4.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audio_tpu.functional as JF
from audio_tpu.ops import rnnt as jax_rnnt

import audio_tpu_torch.functional as TF
from audio_tpu_torch.ops import cuda_rnnt_lps
from audio_tpu_torch.ops import rnnt as port_rnnt

B, T, U, V = 3, 12, 5, 9
LENGTHS = {"full": ([12, 12, 12], [5, 5, 5]), "ragged": ([12, 9, 7], [5, 3, 1]), "short": ([1, 12, 2], [0, 5, 4])}


def _inputs(lengths="ragged", seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    targets = rng.integers(1, V, (B, U)).astype(np.int32)
    ll, tl = (np.asarray(v, np.int32) for v in LENGTHS[lengths])
    return logits, targets, ll, tl


@functools.lru_cache(maxsize=None)
def _jax_costs_and_grad(**kw):
    """The JAX loss and the gradient of its sum, jitted once for each set of options."""
    def summed(x, targets, ll, tl):
        costs = JF.rnnt_loss(x, targets, ll, tl, reduction="none", **kw)
        return costs.sum(), costs

    return jax.jit(jax.value_and_grad(summed, has_aux=True))


def _both(logits, targets, ll, tl, **kw):
    """(port costs, port gradient, JAX costs, JAX gradient) of the summed costs."""
    (_, ref), ref_grad = _jax_costs_and_grad(**kw)(*[jnp.asarray(a) for a in (logits, targets, ll, tl)])
    x = torch.from_numpy(np.array(logits)).requires_grad_()
    got = TF.rnnt_loss(x, *[torch.from_numpy(a) for a in (targets, ll, tl)], reduction="none", **kw)
    got.sum().backward()
    return got.detach().numpy(), x.grad.numpy(), np.asarray(ref), np.asarray(ref_grad)


@pytest.mark.parametrize("lengths", list(LENGTHS))
@pytest.mark.parametrize("blank", [0, V - 1])
def test_costs_and_gradients_match_jax(lengths, blank):
    got, grad, ref, ref_grad = _both(*_inputs(lengths), blank=blank)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grad, ref_grad, atol=1e-5, rtol=1e-4)


def test_a_negative_blank_counts_from_the_end():
    args = [torch.from_numpy(a) for a in _inputs("ragged")]
    assert torch.equal(TF.rnnt_loss(*args, blank=-1, reduction="none"),
                       TF.rnnt_loss(*args, blank=V - 1, reduction="none"))
    assert torch.equal(TF.rnnt_loss(*args, blank=-V, reduction="none"), TF.rnnt_loss(*args, blank=0, reduction="none"))


@pytest.mark.parametrize("kw", [dict(clamp=0.05), dict(fused_log_softmax=False)], ids=["clamp", "log_probs_in"])
def test_options_match_jax(kw):
    logits, targets, ll, tl = _inputs("ragged", seed=1)
    if not kw.get("fused_log_softmax", True):
        logits = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    got, grad, ref, ref_grad = _both(logits, targets, ll, tl, blank=0, **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grad, ref_grad, atol=1e-5, rtol=1e-4)
    if "clamp" in kw:
        assert float(np.abs(grad).max()) <= kw["clamp"] + 1e-7


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_reductions_match_jax(reduction):
    logits, targets, ll, tl = _inputs("ragged", seed=2)
    (_, costs), _ = _jax_costs_and_grad(blank=0)(*[jnp.asarray(a) for a in (logits, targets, ll, tl)])
    ref = {"none": costs, "mean": costs.mean(), "sum": costs.sum()}[reduction]
    got = TF.rnnt_loss(*[torch.from_numpy(a) for a in (logits, targets, ll, tl)], blank=0, reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="reduction"):
        TF.rnnt_loss(*[torch.from_numpy(a) for a in (logits, targets, ll, tl)], reduction="median")


def test_bf16_logits_compute_in_f32_and_return_bf16_gradients():
    logits, targets, ll, tl = _inputs("ragged", seed=3)
    bits = jnp.asarray(logits).astype(jnp.bfloat16)
    (_, ref), ref_grad = _jax_costs_and_grad(blank=0)(bits, *[jnp.asarray(a) for a in (targets, ll, tl)])
    x = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    got = TF.rnnt_loss(x, *[torch.from_numpy(a) for a in (targets, ll, tl)], blank=0, reduction="none")
    got.sum().backward()
    assert got.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref, np.float32), rtol=1e-4, atol=1e-4)
    # both sides round the same f32 gradient to bf16: at most one bf16 step apart
    np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(ref_grad, np.float32), atol=1e-5, rtol=2 ** -7)


def test_gradient_is_zero_outside_the_valid_region():
    logits, targets, ll, tl = _inputs("ragged", seed=4)
    _, grad, _, _ = _both(logits, targets, ll, tl, blank=0)
    for b in range(B):
        assert float(np.abs(grad[b, ll[b]:]).max(initial=0.0)) == 0.0
        assert float(np.abs(grad[b, :, tl[b] + 1:]).max(initial=0.0)) == 0.0
        assert float(np.abs(grad[b, : ll[b], : tl[b] + 1]).max()) > 0.0


def test_alphas_betas_and_occupancies_match_jax():
    logits, targets, ll, tl = _inputs("ragged", seed=5)
    tt = [torch.from_numpy(a) for a in (targets, ll, tl)]
    blank_lp, label_lp, lse = port_rnnt._gather_lps_lazy(torch.from_numpy(logits), tt[0], 0, True)
    jb, jl, jlse = jax_rnnt._gather_lps_lazy(jnp.asarray(logits), jnp.asarray(targets), 0, True)
    for got, ref in ((blank_lp, jb), (label_lp, jl), (lse, jlse)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    costs, alphas, betas = port_rnnt.rnnt_loss_from_logprobs(blank_lp, label_lp, tt[1], tt[2])
    jc, ja, jbt = jax_rnnt.rnnt_loss_from_logprobs(jb, jl, jnp.asarray(ll), jnp.asarray(tl))
    # every cell, the frozen rows past T_b and the -1e30 cells past U_b included
    np.testing.assert_allclose(alphas.numpy(), np.asarray(ja), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(betas.numpy(), np.asarray(jbt), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc), atol=1e-4, rtol=1e-4)
    got = port_rnnt.occupancy_grads(blank_lp, label_lp, alphas, betas, tt[1], tt[2])
    ref = jax_rnnt.occupancy_grads(jb, jl, ja, jbt, jnp.asarray(ll), jnp.asarray(tl))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-4)


def test_semiring_scan_is_the_sequential_recurrence():
    rng = np.random.default_rng(6)
    base = rng.standard_normal((4, 9))
    coeff = rng.standard_normal((4, 9))
    base[1, 5:] = -1e30  # out-of-lattice cells: masked base, masked coefficient into them
    coeff[1, 5:] = -1e30
    want = np.empty_like(base)
    want[:, 0] = base[:, 0]
    for u in range(1, 9):
        want[:, u] = np.logaddexp(base[:, u], want[:, u - 1] + coeff[:, u])
    got = port_rnnt._semiring_scan(torch.from_numpy(base), port_rnnt._coeff_sums(torch.from_numpy(coeff))).numpy()
    np.testing.assert_allclose(got[0], want[0], atol=1e-12, rtol=1e-12)
    np.testing.assert_allclose(got[1, :5], want[1, :5], atol=1e-12, rtol=1e-12)  # cells before the cut
    assert np.isfinite(got).all()


def test_gradcheck_in_float64_on_a_tiny_lattice():
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((2, 4, 3, 5))).requires_grad_()
    targets = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    ll, tl = torch.tensor([4, 3], dtype=torch.int32), torch.tensor([2, 1], dtype=torch.int32)
    for fused in (True, False):
        assert torch.autograd.gradcheck(
            lambda x: TF.rnnt_loss(x, targets, ll, tl, blank=0, reduction="none", fused_log_softmax=fused), (logits,))


def test_the_backward_goes_by_blocks_of_rows(monkeypatch):
    """With a block of a few rows the one-pass gradient equals the single-block one."""
    logits, targets, ll, tl = _inputs("ragged", seed=8)
    _, whole, _, _ = _both(logits, targets, ll, tl, blank=0, clamp=0.05)
    monkeypatch.setattr(port_rnnt, "_GRAD_BLOCK_ELEMS", 7 * V)
    _, blocks, _, _ = _both(logits, targets, ll, tl, blank=0, clamp=0.05)
    assert np.array_equal(whole, blocks)


def test_the_lattice_is_read_through_k8_and_cpu_tensors_launch_nothing(monkeypatch):
    calls = []
    real = cuda_rnnt_lps.lattice_row_stats

    def spy(x, tgt, blank):
        calls.append(tuple(x.shape))
        return real(x, tgt, blank)

    monkeypatch.setattr(port_rnnt, "lattice_row_stats", spy)
    before = dict(cuda_rnnt_lps.launches)
    logits, targets, ll, tl = _inputs("ragged", seed=9)
    TF.rnnt_loss(*[torch.from_numpy(a) for a in (logits, targets, ll, tl)], blank=0)
    assert calls == [(B, T, U + 1, V)] and cuda_rnnt_lps.launches == before
