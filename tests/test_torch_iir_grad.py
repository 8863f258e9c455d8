"""Kernel K4's plain version and the filters' analytic gradients against the JAX package.

``iir_plain`` (what the port runs on CPU tensors and ``chip_smoke.py`` holds the
CUDA kernel against) is compared with the TPU kernel ``iir_pallas`` in
interpret mode and with ``iir_scan``; the gradients of ``lfilter`` and
``iir_apply`` (``torch.autograd.Function``s with the JAX package's analytic
backward) with ``jax.grad`` of the JAX functions.  Inputs have unit scale and
poles inside |z| <= 0.9; gradients agree to atol 1e-4 + rtol 1e-4 (measured
below 3e-5 at every case here: the two sides sum the recurrence in another
order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audio_tpu.functional as JF
from audio_tpu.ops.iir import iir_apply as jax_iir_apply
from audio_tpu.ops.iir import iir_scan as jax_iir_scan
from audio_tpu.ops.pallas_iir import iir_pallas

import audio_tpu_torch.functional as TF
from audio_tpu_torch.ops import cuda_iir, cuda_spectrogram

from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

SHORT = dict(atol=2e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _coeffs(rng, c, order):
    """Stable normalized filters: poles well inside the unit circle."""
    a_tail = 0.2 * rng.standard_normal((c, order)) / np.arange(1, order + 1)
    a = np.concatenate([np.ones((c, 1)), a_tail], axis=1).astype(np.float32)
    b = (0.3 * rng.standard_normal((c, order + 1))).astype(np.float32)
    return a, b


@pytest.mark.parametrize("b,c,t,order", [(2, 2, 300, 1), (3, 1, 700, 2), (1, 2, 333, 8), (2, 1, 450, 12)])
def test_iir_plain_matches_the_interpreted_kernel_and_the_scan(b, c, t, order):
    rng = np.random.default_rng(order)
    x = rng.standard_normal((b, c, t)).astype(np.float32)
    a, _ = _coeffs(rng, c, order)
    a_tail = a[:, 1:].copy()
    got = cuda_iir.iir_allpole(torch.from_numpy(x), torch.from_numpy(a_tail)).numpy()
    np.testing.assert_allclose(got, np.asarray(iir_pallas(jnp.asarray(x), jnp.asarray(a_tail), interpret=True)),
                               **SHORT)
    np.testing.assert_allclose(got, np.asarray(jax_iir_scan(jnp.asarray(x), jnp.asarray(a_tail))), **SHORT)


@pytest.mark.parametrize("t", [100, 513])
def test_reverse_runs_the_recurrence_backwards_in_time(t):
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((2, 2, t)).astype(np.float32))
    a_tail = torch.from_numpy(_coeffs(rng, 2, 3)[0][:, 1:].copy())
    flipped = torch.flip(cuda_iir.iir_plain(torch.flip(x, (-1,)), a_tail), (-1,))
    got = cuda_iir.iir_allpole(x, a_tail, reverse=True)
    assert torch.equal(got, flipped)
    # y[t] = x[t] - sum_k a[k] y[t+k], checked at the last samples by hand
    assert float(got[0, 0, -1]) == float(x[0, 0, -1])
    np.testing.assert_allclose(float(got[0, 0, -2]), float(x[0, 0, -2] - a_tail[0, 0] * got[0, 0, -1]), rtol=1e-6)


@pytest.mark.parametrize("order,t", [(1, 200), (2, 300), (8, 130), (12, 333)])
def test_lfilter_gradients_match_jax(order, t):
    rng = np.random.default_rng(10 + order)
    x = rng.standard_normal((2, 2, t)).astype(np.float32)
    w = rng.standard_normal((2, 2, t)).astype(np.float32)
    a, b = _coeffs(rng, 2, order)

    def jloss(x_, a_, b_):
        return jnp.sum(JF.lfilter(x_, a_, b_, clamp=False) * jnp.asarray(w))

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, a, b)]
    (TF.lfilter(*leaves, clamp=False) * torch.from_numpy(w)).sum().backward()
    for name, leaf, r in zip(("dx", "da", "db"), leaves, ref):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(leaf.grad.numpy() / scale, np.asarray(r) / scale, err_msg=name, **GRAD)


@pytest.mark.parametrize("order,t", [(1, 200), (2, 300), (8, 130), (12, 333)])
def test_iir_apply_gradients_match_jax(order, t):
    rng = np.random.default_rng(20 + order)
    x = rng.standard_normal((2, 2, t)).astype(np.float32)
    w = rng.standard_normal((2, 2, t)).astype(np.float32)
    a, _ = _coeffs(rng, 2, order)
    ref_y = jax_iir_apply(jnp.asarray(x), jnp.asarray(a))
    ref = jax.jit(jax.grad(lambda x_, a_: jnp.sum(jax_iir_apply(x_, a_) * jnp.asarray(w)), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(a))
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, a)]
    y = cuda_iir.iir_apply(*leaves)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y), **SHORT)
    (y * torch.from_numpy(w)).sum().backward()
    for name, leaf, r in zip(("dx", "da"), leaves, ref):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(leaf.grad.numpy() / scale, np.asarray(r) / scale, err_msg=name, **GRAD)


def test_analytic_backward_passes_gradcheck_in_float64():
    gen = torch.Generator().manual_seed(0)
    # 260 samples take the blocked engine (two blocks, the second ragged); one lane keeps it quick
    x = torch.randn(1, 1, 260, dtype=torch.float64, generator=gen, requires_grad=True)
    a_tail = torch.tensor([[-0.5, 0.2]], dtype=torch.float64, requires_grad=True)
    b = torch.tensor([[0.3, 0.2, 0.1]], dtype=torch.float64, requires_grad=True)

    def a_norm(tail):
        return torch.cat([torch.ones(1, 1, dtype=torch.float64), tail], dim=1)

    assert torch.autograd.gradcheck(lambda x_, t_, b_: cuda_iir.lfilter_fused(x_, a_norm(t_), b_), (x, a_tail, b))
    assert torch.autograd.gradcheck(lambda x_, t_: cuda_iir.iir_apply(x_, a_norm(t_)), (x, a_tail))


def test_tap_sums_need_no_window_gather():
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((3, 2, 50)))
    s = torch.from_numpy(rng.standard_normal((3, 2, 50)))
    got = cuda_iir._tap_sums(g, s, 4)
    padded = torch.nn.functional.pad(s, (3, 0))
    for k in range(4):
        want = (g * padded[..., 3 - k: 53 - k]).sum(dim=(0, 2))
        np.testing.assert_allclose(got[:, k].numpy(), want.numpy(), atol=1e-12, rtol=1e-12)
    assert tuple(cuda_iir._tap_sums(g[..., :2], s[..., :2], 4).shape) == (2, 4)


def test_cpu_tensors_launch_nothing():
    before = (cuda_iir.launches, cuda_iir.iir_launches, cuda_spectrogram.launches)
    x = torch.randn(1, 1, 400, requires_grad=True)
    y = TF.lfilter(x, torch.tensor([1.0, -0.5]), torch.tensor([0.5, 0.1]), clamp=False)
    TF.spectrogram(y, window=torch.hann_window(64), n_fft=64, hop_length=32).sum().backward()
    assert (cuda_iir.launches, cuda_iir.iir_launches, cuda_spectrogram.launches) == before


@pytest.mark.parametrize("mel", [False, True])
def test_spectrogram_kernels_backward_recomputes_through_the_plain_version(monkeypatch, mel):
    """The autograd.Function that wraps kernel K2, with the launch stood in for by the plain
    version (the kernel runs only on the card): its gradients are autograd's of the plain version."""
    monkeypatch.setattr(cuda_spectrogram, "_power_spectrogram_kernel",
                        lambda w, win, n, h, p, fb: cuda_spectrogram.power_spectrogram_plain(w, win, n, h, p, fb))
    rng = np.random.default_rng(4)
    wave = torch.from_numpy(rng.standard_normal((2, 1200))).requires_grad_()
    window = torch.hann_window(400, dtype=torch.float64)
    fb = torch.from_numpy(rng.random((201, 8))).requires_grad_() if mel else None
    out = cuda_spectrogram._PowerSpectrogramFn.apply(wave, window, fb, 400, 160, 2.0)
    g = torch.from_numpy(rng.standard_normal(tuple(out.shape)))
    wanted = [wave] + ([fb] if mel else [])
    got = torch.autograd.grad(out, wanted, g)
    ref_in = [t.detach().requires_grad_() for t in wanted]
    ref_out = cuda_spectrogram.power_spectrogram_plain(ref_in[0], window, 400, 160, 2.0, ref_in[1] if mel else None)
    for a, r in zip(got, torch.autograd.grad(ref_out, ref_in, g)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-12, rtol=1e-12)
