"""The port's CTC loss and greedy decoding (CPU) against the JAX package.

``audio_tpu_torch.ops.ctc`` against ``audio_tpu.ops.ctc`` on the same seeded
numpy inputs, in float64 (x64 on, as ``tests/conftest.py`` sets it), to the
JAX package's own tolerances (tests/functional/test_ctc.py): losses 1e-5 abs
+ 1e-6 rel, reductions 1e-6 rel, gradients 1e-5 abs + 1e-5 rel; the gradient
against ``jax.grad`` of the JAX loss, jitted once per shape.  In float32,
1e-5 abs + 1e-4 rel.  The decoder's tokens and counts are equal.  An
infeasible target gives a loss near 1e30 (not inf, as
``torch.nn.functional.ctc_loss`` gives), which ``zero_infinity`` zeroes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_tpu.ops import ctc as jax_ctc

from audio_tpu_torch.ops import ctc as tctc


def _case(seed, b=3, t=20, c=7, l=6, dtype=np.float64):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, c))
    lp = torch.log_softmax(torch.from_numpy(logits), -1).numpy().astype(dtype)
    targets = rng.integers(1, c, (b, l))
    il = rng.integers(l * 2 + 2, t + 1, b)
    il[0] = t
    tl = rng.integers(1, l + 1, b)
    tl[0] = l
    return logits, lp, targets, il, tl


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_matches_jax(seed, dtype, reduction):
    _, lp, targets, il, tl = _case(seed, dtype=dtype)
    ref = np.asarray(jax_ctc.ctc_loss(*_j(lp, targets, il, tl), blank=0, reduction=reduction))
    got = tctc.ctc_loss(*_t(lp, targets, il, tl), blank=0, reduction=reduction)
    assert got.dtype == torch.from_numpy(lp).dtype and tuple(got.shape) == ref.shape
    tol = (dict(atol=1e-5, rtol=1e-6) if reduction == "none" else dict(atol=0, rtol=1e-6)) \
        if dtype == np.float64 else dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref, **tol)


def test_ctc_loss_matches_torch_on_feasible_targets():
    _, lp, targets, il, tl = _case(2)
    want = torch.nn.functional.ctc_loss(torch.from_numpy(lp).transpose(0, 1), *_t(targets, il, tl), blank=0,
                                        reduction="none")
    got = tctc.ctc_loss(*_t(lp, targets, il, tl), blank=0, reduction="none")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-6)


def test_ctc_loss_defaults_and_blank_inside_the_alphabet():
    """No lengths (every frame, every label), and the blank at index 3 with labels around it."""
    _, lp, targets, _, _ = _case(3, b=2, t=16, c=6, l=4)
    targets = np.where(targets == 3, 5, targets)
    ref = np.asarray(jax_ctc.ctc_loss(*_j(lp, targets), blank=3, reduction="none"))
    got = tctc.ctc_loss(*_t(lp, targets), blank=3, reduction="none")
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-6)


def test_ctc_loss_gradient_matches_jax_grad():
    """The gradient to the raw logits through log_softmax, from autograd through the loop over the
    frames, against jax.grad of the JAX loss (jitted once for this shape)."""
    logits, _, targets, il, tl = _case(1)
    jt = _j(targets, il, tl)
    grad_fn = jax.jit(jax.grad(lambda u: jax_ctc.ctc_loss(jax.nn.log_softmax(u, -1), *jt, blank=0,
                                                          reduction="mean")))
    ref = np.asarray(grad_fn(jnp.asarray(logits)))
    u = torch.from_numpy(logits).requires_grad_(True)
    tctc.ctc_loss(torch.log_softmax(u, -1), *_t(targets, il, tl), blank=0, reduction="mean").backward()
    np.testing.assert_allclose(u.grad.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_infeasible_target_gives_1e30_and_zero_infinity_zeroes_it():
    """Three labels in two frames cannot be emitted: -log p near 1e30, not inf; zero_infinity gives 0
    for it and leaves the feasible row."""
    _, lp, targets, _, _ = _case(4, b=2, t=8, c=5, l=3)
    il, tl = np.asarray([2, 8]), np.asarray([3, 3])
    ref = np.asarray(jax_ctc.ctc_loss(*_j(lp, targets, il, tl), reduction="none"))
    got = tctc.ctc_loss(*_t(lp, targets, il, tl), reduction="none")
    assert 1e29 < float(got[0]) < 2e30 and np.isfinite(float(got[0]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    zeroed = tctc.ctc_loss(*_t(lp, targets, il, tl), reduction="none", zero_infinity=True)
    assert float(zeroed[0]) == 0.0 and float(zeroed[1]) == float(got[1])
    np.testing.assert_allclose(
        zeroed.numpy(), np.asarray(jax_ctc.ctc_loss(*_j(lp, targets, il, tl), reduction="none", zero_infinity=True)),
        rtol=1e-6)


@pytest.mark.parametrize("blank", [0, 4])
@pytest.mark.parametrize("with_lengths", [False, True], ids=["all_frames", "lengths"])
def test_ctc_greedy_decode_matches_jax(with_lengths, blank):
    """Argmax a frame (ties on a coarse grid, won by the first index), repeats collapsed, blanks
    dropped, compacted in order by a stable sort; padded with -1."""
    rng = np.random.default_rng(5)
    lp = np.round(rng.standard_normal((4, 30, 5)) * 2) / 2  # exact ties
    lengths = np.asarray([30, 17, 1, 0]) if with_lengths else None
    args = (lp,) if lengths is None else (lp, lengths)
    tok_ref, cnt_ref = jax_ctc.ctc_greedy_decode(*_j(*args), blank=blank)
    tok, cnt = tctc.ctc_greedy_decode(*_t(*args), blank=blank)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_ref))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_ref))
    assert int(cnt.min()) >= 0 and bool((tok[:, int(cnt.max()):] == -1).all())


def test_ctc_greedy_decode_collapses_a_known_path():
    path = [1, 1, 0, 2, 2, 2, 0, 0, 1]
    lp = np.full((1, len(path), 3), -10.0)
    lp[0, np.arange(len(path)), path] = 0.0
    tok, cnt = tctc.ctc_greedy_decode(torch.from_numpy(lp))
    assert int(cnt[0]) == 3 and tok[0, :3].tolist() == [1, 2, 1] and bool((tok[0, 3:] == -1).all())
