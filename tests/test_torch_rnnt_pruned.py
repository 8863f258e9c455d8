"""The port's simple and pruned transducer losses against the JAX package.

The same numpy inputs go through ``audio_tpu.functional`` and the port.
Tolerances: costs rtol = atol = 1e-4, gradients atol 1e-5 + rtol 1e-4 (the
simple loss's gradients, which autograd chains through a product of
exponentials on either side, atol 1e-4); prune ranges are integers and equal.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audio_tpu.functional as JF

import audio_tpu_torch.functional as TF
from audio_tpu_torch.ops import rnnt_pruned as port_pruned

from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

B, T, U, V, D = 3, 14, 6, 11, 8
LL, TL = np.array([14, 9, 7], np.int32), np.array([6, 3, 1], np.int32)


def _heads(seed=0):
    rng = np.random.default_rng(seed)
    am = rng.standard_normal((B, T, V)).astype(np.float32)
    lm = rng.standard_normal((B, U + 1, V)).astype(np.float32)
    targets = rng.integers(1, V, (B, U)).astype(np.int32)
    return am, lm, targets


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def simple():
    am, lm, targets = _heads()
    costs, post = jax.jit(lambda *a: JF.rnnt_loss_simple(*a, blank=0, reduction="none"))(
        *[jnp.asarray(a) for a in (am, lm, targets, LL, TL)])
    return am, lm, targets, np.asarray(costs), np.asarray(post)


def test_simple_loss_and_posteriors_match_jax(simple):
    am, lm, targets, ref_costs, ref_post = simple
    a, l = (t.requires_grad_() for t in _t(am, lm))
    costs, post = TF.rnnt_loss_simple(a, l, *_t(targets, LL, TL), blank=0, reduction="none")
    assert not post.requires_grad
    np.testing.assert_allclose(costs.detach().numpy(), ref_costs, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(post.numpy(), ref_post, atol=1e-4, rtol=1e-4)
    j = [jnp.asarray(x) for x in (targets, LL, TL)]
    ref = jax.jit(jax.grad(lambda a_, l_: JF.rnnt_loss_simple(a_, l_, *j, blank=0, reduction="sum")[0],
                           argnums=(0, 1)))(jnp.asarray(am), jnp.asarray(lm))
    costs.sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(l.grad.numpy(), np.asarray(ref[1]), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s", [2, 3, 4, 7, 8])
def test_prune_ranges_equal_jax_exactly(simple, s):
    post = simple[4]
    ref = np.asarray(_jax_ranges(jnp.asarray(post), jnp.asarray(LL), jnp.asarray(TL), s))
    got = TF.get_rnnt_prune_ranges(*_t(post, LL, TL), s)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)
    start = got[:, :, 0].numpy()
    assert (start[:, 0] == 0).all() and (np.diff(start, axis=1) >= 0).all() and (np.diff(start, axis=1) <= s - 1).all()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_prune_ranges_equal_jax_on_flat_posteriors_with_ties(seed):
    rng = np.random.default_rng(seed)
    post = np.round(rng.random((B, T, U + 1)), 1).astype(np.float32)  # many equal window sums
    for s in (3, 5):
        ref = np.asarray(_jax_ranges(jnp.asarray(post), jnp.asarray(LL), jnp.asarray(TL), s))
        assert np.array_equal(TF.get_rnnt_prune_ranges(*_t(post, LL, TL), s).numpy(), ref)


@pytest.mark.parametrize("s", [3, 8])
def test_prune_target_encodings_match_jax_with_gradient(simple, s):
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((B, U + 1, D)).astype(np.float32)
    w = rng.standard_normal((B, T, s, D)).astype(np.float32)
    ranges = _jax_ranges(jnp.asarray(simple[4]), jnp.asarray(LL), jnp.asarray(TL), s)
    ref = JF.prune_target_encodings(jnp.asarray(enc), ranges)
    ref_grad = jax.grad(lambda e: jnp.sum(JF.prune_target_encodings(e, ranges) * jnp.asarray(w)))(jnp.asarray(enc))
    e = torch.from_numpy(enc).requires_grad_()
    got = TF.prune_target_encodings(e, torch.from_numpy(np.asarray(ranges)))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=0, rtol=0)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ref_grad), atol=1e-6, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_pruned(**kw):
    """The JAX pruned loss and the gradient of its sum, jitted once for each set of options."""
    def summed(x, targets, ranges, ll, tl):
        costs = JF.rnnt_loss_pruned(x, targets, ranges, ll, tl, blank=0, reduction="none", **kw)
        return costs.sum(), costs

    return jax.jit(jax.value_and_grad(summed, has_aux=True))


_jax_ranges = jax.jit(JF.get_rnnt_prune_ranges, static_argnums=3)


def _pruned_both(logits, targets, ranges, **kw):
    (_, ref), ref_grad = _jax_pruned(**kw)(*[jnp.asarray(a) for a in (logits, targets, ranges, LL, TL)])
    x = torch.from_numpy(np.array(logits)).requires_grad_()
    got = TF.rnnt_loss_pruned(x, *_t(targets, ranges, LL, TL), blank=0, reduction="none", **kw)
    got.sum().backward()
    return got.detach().numpy(), x.grad.numpy(), np.asarray(ref), np.asarray(ref_grad)


@pytest.mark.parametrize("s", [3, 8])
@pytest.mark.parametrize("kw", [dict(), dict(clamp=0.05), dict(fused_log_softmax=False)],
                         ids=["plain", "clamp", "log_probs_in"])
def test_pruned_loss_and_gradients_match_jax(simple, s, kw):
    rng = np.random.default_rng(10 + s)
    logits = rng.standard_normal((B, T, s, V)).astype(np.float32)
    if not kw.get("fused_log_softmax", True):
        logits = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    ranges = np.asarray(_jax_ranges(jnp.asarray(simple[4]), jnp.asarray(LL), jnp.asarray(TL), s))
    got, grad, ref, ref_grad = _pruned_both(logits, simple[2], ranges, **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grad, ref_grad, atol=1e-5, rtol=1e-4)
    for b in range(B):  # nothing flows into frames past T_b
        assert float(np.abs(grad[b, LL[b]:]).max(initial=0.0)) == 0.0


def test_a_band_over_the_whole_lattice_equals_the_full_loss(simple):
    rng = np.random.default_rng(20)
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    ranges = np.broadcast_to(np.arange(U + 1, dtype=np.int32), (B, T, U + 1)).copy()
    x = torch.from_numpy(logits)
    full = TF.rnnt_loss(x, *_t(simple[2], LL, TL), blank=0, reduction="none")
    band = TF.rnnt_loss_pruned(x, *_t(simple[2], ranges, LL, TL), blank=0, reduction="none")
    np.testing.assert_allclose(band.numpy(), full.numpy(), atol=1e-4, rtol=1e-5)


def test_a_band_that_cannot_reach_the_targets_costs_infinity(simple):
    logits = np.zeros((B, T, 2, V), np.float32)
    ranges = np.ones((B, T, 2), np.int32) + np.arange(2, dtype=np.int32)  # the origin is out of band
    got = TF.rnnt_loss_pruned(*_t(logits, simple[2], ranges, LL, TL), blank=0, reduction="none")
    assert bool(torch.isinf(got).all())


def test_bf16_band_computes_in_f32(simple):
    s = 4
    rng = np.random.default_rng(21)
    logits = rng.standard_normal((B, T, s, V)).astype(np.float32)
    ranges = np.asarray(_jax_ranges(jnp.asarray(simple[4]), jnp.asarray(LL), jnp.asarray(TL), s))
    bits = jnp.asarray(logits).astype(jnp.bfloat16)
    (_, ref), _ = _jax_pruned()(bits, *[jnp.asarray(a) for a in (simple[2], ranges, LL, TL)])
    x = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    got = TF.rnnt_loss_pruned(x, *_t(simple[2], ranges, LL, TL), blank=0, reduction="none")
    got.sum().backward()
    assert got.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref, np.float32), rtol=1e-4, atol=1e-4)


def test_gradcheck_in_float64_on_a_tiny_band():
    rng = np.random.default_rng(22)
    targets = torch.tensor([[1, 2, 3], [3, 4, 1]], dtype=torch.int32)
    ll, tl = torch.tensor([5, 4], dtype=torch.int32), torch.tensor([3, 2], dtype=torch.int32)
    # the log-prob-level loss under the simple loss
    blank_lp = torch.from_numpy(-1.0 - rng.random((2, 5, 4))).requires_grad_()
    label_lp = torch.from_numpy(-1.0 - rng.random((2, 5, 3))).requires_grad_()
    assert torch.autograd.gradcheck(lambda bl, lb: port_pruned._LpsLossFn.apply(bl, lb, ll, tl)[0],
                                    (blank_lp, label_lp))
    # the banded loss, on a band of two slots that climbs one target a frame
    start = torch.tensor([[0, 0, 1, 2, 2], [0, 1, 1, 1, 1]], dtype=torch.int32)
    ranges = start[:, :, None] + torch.arange(2, dtype=torch.int32)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 2, 6))).requires_grad_()
    for fused in (True, False):
        assert torch.autograd.gradcheck(
            lambda x: TF.rnnt_loss_pruned(x, targets, ranges, ll, tl, blank=0, reduction="none",
                                          fused_log_softmax=fused), (logits,))
