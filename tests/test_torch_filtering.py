"""The port's filters (CPU, plain versions) against the JAX package.

Inputs are float32 numpy arrays from a seed, fed to both sides.  Tolerances
are those of the JAX package's IIR tests (tests/ops/test_pallas_iir.py): the
two sides sum the recurrence in another order (the port builds the impulse
response sequentially, the JAX side by an associative scan), so short
signals agree to atol 2e-5 / rtol 1e-5 and long ones, where rounding
accumulates through the poles, to atol 2e-4 / rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audio_tpu.functional as JF
from audio_tpu.functional._filtering import _fir_causal as jax_fir_causal
from audio_tpu.ops.iir import allpole_impulse_response as jax_impulse
from audio_tpu.ops.iir import iir_scan as jax_iir_scan
from audio_tpu.ops.pallas_iir import lfilter_pallas

import audio_tpu_torch.functional as TF
from audio_tpu_torch.ops import cuda_iir
from audio_tpu_torch.ops.iir import allpole_impulse_response, fir_causal, iir_blocked, iir_scan

from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

SHORT = dict(atol=2e-5, rtol=1e-5)
LONG = dict(atol=2e-4, rtol=1e-4)


def _np(x):
    return np.array(x, dtype=np.float32)


def _coeffs(rng, c, order):
    """Stable normalized filters of the JAX IIR tests' kind."""
    a_tail = 0.2 * rng.standard_normal((c, order)) / np.arange(1, order + 1)
    a = np.concatenate([np.ones((c, 1)), a_tail], axis=1).astype(np.float32)
    b = (0.3 * rng.standard_normal((c, order + 1))).astype(np.float32)
    return a, b


@pytest.mark.parametrize(
    "b,c,t,order",
    # the scan path (T <= 256); longer signals are held against the TPU kernel below
    [(2, 3, 200, 2), (1, 1, 256, 1)],
)
def test_lfilter_matches_jax(b, c, t, order):
    rng = np.random.default_rng(order + t)
    x = rng.standard_normal((b, c, t)).astype(np.float32) * 0.1
    a, bc = _coeffs(rng, c, order)
    ref = _np(JF.lfilter(jnp.asarray(x), jnp.asarray(a), jnp.asarray(bc), clamp=False))
    got = TF.lfilter(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(bc), clamp=False)
    np.testing.assert_allclose(got.numpy(), ref, **SHORT)


def test_lfilter_long_signal_matches_jax():
    # poles at |z| ~ 0.85 over 5000 samples, as the JAX long-signal test
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    a = np.array([1.0, -1.62, 0.729], np.float32)
    b = np.array([0.5, 0.2, -0.1], np.float32)
    ref = _np(JF.lfilter(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), clamp=False))
    got = TF.lfilter(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), clamp=False)
    np.testing.assert_allclose(got.numpy(), ref, **LONG)


@pytest.mark.parametrize(
    "b,c,t,order", [(2, 2, 700, 2), (3, 1, 300, 1), (1, 2, 400, 16), (3, 1, 1000, 4), (1, 2, 777, 1)]
)
def test_lfilter_plain_matches_pallas_interpret(b, c, t, order):
    """K1's plain version against the TPU kernel run in interpret mode."""
    rng = np.random.default_rng(5 + order)
    x = rng.standard_normal((b, c, t)).astype(np.float32) * 0.1
    a, bc = _coeffs(rng, c, order)
    ref = _np(lfilter_pallas(jnp.asarray(x), jnp.asarray(a), jnp.asarray(bc), interpret=True))
    got = cuda_iir.lfilter_fused(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(bc))
    np.testing.assert_allclose(got.numpy(), ref, **SHORT)


def test_lfilter_on_cpu_does_not_launch():
    before = cuda_iir.launches
    x = torch.zeros((1, 1, 300))
    a = torch.tensor([[1.0, -0.5]])
    b = torch.tensor([[1.0, 0.0]])
    cuda_iir.lfilter_fused(x, a, b)
    assert cuda_iir.launches == before


@pytest.mark.parametrize(
    "design,args",
    [
        ("lowpass_biquad", (16000, 4000.0)),
        ("highpass_biquad", (16000, 1000.0)),
        ("allpass_biquad", (16000, 2000.0)),
        ("bandpass_biquad", (16000, 2000.0, 0.707, True)),
        ("bandreject_biquad", (16000, 2000.0)),
        ("band_biquad", (16000, 2000.0, 0.707, True)),
        # at the default 100 Hz shelf the poles sit at |z| = 0.977, where the JAX
        # side's blocked Toeplitz path is itself 7e-4 off a float64 reference
        ("bass_biquad", (16000, 6.0, 1000)),
        ("treble_biquad", (16000, -3.0)),
        ("equalizer_biquad", (16000, 1500.0, 4.0)),
        ("deemph_biquad", (44100,)),
        ("riaa_biquad", (44100,)),
    ],
)
def test_biquad_designs_match_jax(design, args):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 1000)).astype(np.float32) * 0.2
    ref = _np(getattr(JF, design)(jnp.asarray(x), *args))
    got = getattr(TF, design)(torch.from_numpy(x), *args)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **SHORT)


def test_biquad_and_filtfilt_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 600)).astype(np.float32) * 0.3
    coeffs = (0.2, 0.3, 0.1, 1.0, -0.4, 0.2)
    np.testing.assert_allclose(
        TF.biquad(torch.from_numpy(x), *coeffs).numpy(), _np(JF.biquad(jnp.asarray(x), *coeffs)), **SHORT
    )
    a = np.array([1.0, -0.6, 0.25], np.float32)
    b = np.array([0.3, 0.2, 0.1], np.float32)
    ref = _np(JF.filtfilt(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))
    got = TF.filtfilt(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref, **SHORT)


def test_lfilter_batching_false_and_a0_normalisation():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 500)).astype(np.float32) * 0.1
    a = np.array([[2.0, -0.8, 0.3], [1.5, 0.2, -0.1]], np.float32)  # a0 != 1
    b = np.array([[0.4, 0.2, 0.0], [0.3, -0.1, 0.2]], np.float32)
    ref = _np(JF.lfilter(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), batching=False))
    got = TF.lfilter(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), batching=False)
    assert got.shape == (2, 2, 500)
    np.testing.assert_allclose(got.numpy(), ref, **SHORT)


def test_lfilter_validation():
    x = torch.zeros((2, 300))
    with pytest.raises(ValueError, match="same size"):
        TF.lfilter(x, torch.tensor([1.0, 0.5]), torch.tensor([1.0, 0.5, 0.2]))
    with pytest.raises(ValueError, match="number of batches"):
        TF.lfilter(x, torch.ones((3, 2)), torch.ones((3, 2)))


def test_cpu_autograd():
    """The CPU path differentiates through plain torch ops.

    The filter is linear in x and its FIR and IIR stages commute, so the
    gradient of <w, lfilter(x)> is flip(lfilter(flip(w))), the identity the
    JAX package's custom VJP is built on.  The coefficient gradients are
    held against central differences in float64.
    """
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 2, 400)) * 0.1).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((2, 2, 400)))
    a = torch.tensor([[1.0, -0.5, 0.2], [1.0, 0.3, -0.1]], dtype=torch.float64, requires_grad=True)
    b = torch.tensor([[0.3, 0.2, 0.1], [0.5, -0.2, 0.0]], dtype=torch.float64, requires_grad=True)

    def loss(a, b):
        return (w * TF.lfilter(x, a, b, clamp=False)).sum()

    loss(a, b).backward()
    with torch.no_grad():
        dx = torch.flip(TF.lfilter(torch.flip(w, (-1,)), a, b, clamp=False), (-1,))
        np.testing.assert_allclose(x.grad.numpy(), dx.numpy(), atol=1e-10, rtol=1e-8)
        eps = 1e-6
        for coeffs, grad in ((a, a.grad), (b, b.grad)):
            for idx in [(0, 1), (1, 2)]:
                coeffs[idx] += eps
                hi = loss(a, b)
                coeffs[idx] -= 2 * eps
                lo = loss(a, b)
                coeffs[idx] += eps
                np.testing.assert_allclose(float(grad[idx]), float(hi - lo) / (2 * eps), rtol=1e-5)


def test_iir_engines_match_jax_scan():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 450)).astype(np.float32)
    a_tail = (0.2 * rng.standard_normal((3, 4)) / np.arange(1, 5)).astype(np.float32)
    ref = _np(jax_iir_scan(jnp.asarray(x), jnp.asarray(a_tail)))
    xt, at = torch.from_numpy(x), torch.from_numpy(a_tail)
    np.testing.assert_allclose(iir_scan(xt, at).numpy(), ref, **SHORT)
    np.testing.assert_allclose(iir_blocked(xt, at).numpy(), ref, **SHORT)


def test_impulse_response_and_fir_match_jax():
    rng = np.random.default_rng(8)
    # one channel of order 2: the shape the biquad tests above already compiled on the JAX side
    a_tail = np.array([[-1.62, 0.729]], np.float32)
    ref = _np(jax_impulse(jnp.asarray(a_tail), 128))
    np.testing.assert_allclose(allpole_impulse_response(torch.from_numpy(a_tail), 128).numpy(), ref, **SHORT)
    x = rng.standard_normal((2, 2, 50)).astype(np.float32)
    b = rng.standard_normal((2, 5)).astype(np.float32)
    np.testing.assert_allclose(
        fir_causal(torch.from_numpy(x), torch.from_numpy(b)).numpy(),
        _np(jax_fir_causal(jnp.asarray(x), jnp.asarray(b))),
        **SHORT,
    )
