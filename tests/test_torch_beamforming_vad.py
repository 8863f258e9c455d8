"""The port's beamforming ops and ``vad`` (CPU) against the JAX package.

The same seeded numpy inputs go through ``audio_tpu.functional`` (x64 on, as
``tests/conftest.py`` sets it) and ``audio_tpu_torch.functional``.  The JAX
package's tests hold the beamformers only to their own low-precision runs, so
the tolerances here are the port's defaults, relative to each output's peak:
1e-9 in complex128 and 1e-5 abs + 1e-4 rel in complex64.  ``rtf_evd``
returns an eigenvector, which each eigensolver may give times its own unit
factor: it is compared after taking that factor out, frequency by frequency,
and the MVDR weights built from it (invariant to the factor) directly.
``vad`` returns a slice of its input whose length depends on a ``>=`` against
``trigger_level``: on recordings that trigger clearly (noise, a voiced tone,
noise; the JAX package's ``tests/functional/test_vad.py``), the same slice.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audio_tpu.functional as JF

import audio_tpu_torch.functional as TF

from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

CTYPES = [np.complex128, np.complex64]


def _ids(dt):
    return np.dtype(dt).name


def _close(got: torch.Tensor, ref, dtype):
    ref = np.asarray(ref)
    assert got.dtype == torch.from_numpy(ref.astype(dtype)).dtype and tuple(got.shape) == ref.shape
    peak = max(float(np.abs(ref).max()), 1e-30)
    tol = dict(atol=1e-9, rtol=0) if dtype == np.complex128 else dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy() / peak, ref / peak, **tol)


def _stft(seed: int, dtype, shape=(2, 4, 9, 30)) -> np.ndarray:
    """A multichannel complex STFT (..., channel, freq, time): a shared source through a random
    channel response, plus independent noise."""
    rng = np.random.default_rng(seed)
    b, c, f, t = shape
    src = rng.standard_normal((b, 1, f, t)) + 1j * rng.standard_normal((b, 1, f, t))
    h = rng.standard_normal((b, c, f, 1)) + 1j * rng.standard_normal((b, c, f, 1))
    noise = 0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    return (src * h + noise).astype(dtype)


def _psds(dtype):
    spec = _stft(1, dtype)
    rng = np.random.default_rng(2)
    mask_s = rng.uniform(0, 1, (2, 9, 30)).astype(np.float64 if dtype == np.complex128 else np.float32)
    j = [np.asarray(JF.psd(jnp.asarray(spec), jnp.asarray(m))) for m in (mask_s, 1 - mask_s)]
    t = [TF.psd(torch.from_numpy(spec), torch.from_numpy(m)) for m in (mask_s, 1 - mask_s)]
    return spec, j, t


@pytest.mark.parametrize("dtype", CTYPES, ids=_ids)
@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
def test_psd_matches_jax(normalize, dtype):
    spec = _stft(3, dtype)
    mask = np.random.default_rng(4).uniform(0, 1, (2, 9, 30)).astype(spec.real.dtype)
    _close(TF.psd(torch.from_numpy(spec), torch.from_numpy(mask), normalize=normalize),
           JF.psd(jnp.asarray(spec), jnp.asarray(mask), normalize=normalize), dtype)
    _close(TF.psd(torch.from_numpy(spec)), JF.psd(jnp.asarray(spec)), dtype)


@pytest.mark.parametrize("dtype", CTYPES, ids=_ids)
def test_mvdr_souden_and_rtf_power_match_jax(dtype):
    """With diagonal loading and without, an int reference channel and a one-hot tensor one."""
    _, (js, jn), (ts, tn) = _psds(dtype)
    onehot = np.eye(4)[1].astype(np.float32)
    for ref in (0, onehot):
        jref, tref = (ref, ref) if isinstance(ref, int) else (jnp.asarray(ref), torch.from_numpy(ref))
        for loading in (True, False):
            _close(TF.mvdr_weights_souden(ts, tn, tref, diagonal_loading=loading),
                   JF.mvdr_weights_souden(jnp.asarray(js), jnp.asarray(jn), jref, diagonal_loading=loading), dtype)
        for n_iter in (1, 2, 3):
            _close(TF.rtf_power(ts, tn, tref, n_iter=n_iter),
                   JF.rtf_power(jnp.asarray(js), jnp.asarray(jn), jref, n_iter=n_iter), dtype)


@pytest.mark.parametrize("dtype", CTYPES, ids=_ids)
def test_rtf_evd_matches_jax_up_to_a_unit_factor_and_its_mvdr_weights_directly(dtype):
    _, (js, jn), (ts, tn) = _psds(dtype)
    ref = np.asarray(JF.rtf_evd(jnp.asarray(js)))
    got = TF.rtf_evd(ts)
    inner = np.sum(np.conj(ref) * got.numpy(), axis=-1, keepdims=True)  # e^{i phi} |v|^2, |v| = 1
    phase = inner / np.abs(inner)
    np.testing.assert_allclose(np.abs(inner), 1.0, atol=1e-4 if dtype == np.complex64 else 1e-9)
    _close(got * torch.from_numpy(np.conj(phase)), ref, dtype)
    for ref_channel in (2, torch.from_numpy(np.eye(4)[2].astype(np.float32))):
        jref = ref_channel if isinstance(ref_channel, int) else jnp.asarray(ref_channel.numpy())
        w = TF.mvdr_weights_rtf(got, tn, ref_channel)
        _close(w, JF.mvdr_weights_rtf(jnp.asarray(ref), jnp.asarray(jn), jref), dtype)
    _close(TF.mvdr_weights_rtf(got * torch.from_numpy(np.conj(phase)), tn, None, diagonal_loading=False),
           JF.mvdr_weights_rtf(jnp.asarray(ref), jnp.asarray(jn), None, diagonal_loading=False), dtype)


@pytest.mark.parametrize("dtype", CTYPES, ids=_ids)
def test_apply_beamforming_matches_jax(dtype):
    spec, (js, jn), (ts, tn) = _psds(dtype)
    w = TF.mvdr_weights_souden(ts, tn, 0)
    _close(TF.apply_beamforming(w, torch.from_numpy(spec)),
           JF.apply_beamforming(jnp.asarray(w.numpy()), jnp.asarray(spec)), dtype)


def test_beamforming_raises_as_the_jax_package():
    psd_c = torch.zeros(2, 9, 4, 4, dtype=torch.complex64)
    with pytest.raises(TypeError, match="complex"):
        TF.mvdr_weights_souden(psd_c.real, psd_c.real, 0)
    with pytest.raises(ValueError, match="same"):
        TF.rtf_power(psd_c, psd_c[:, :3], 0)
    with pytest.raises(ValueError, match="iteration"):
        TF.rtf_power(psd_c, psd_c, 0, n_iter=0)
    with pytest.raises(ValueError, match="should match"):
        TF.mvdr_weights_rtf(torch.zeros(2, 9, 3, dtype=torch.complex64), psd_c)
    with pytest.raises(TypeError, match="complex"):
        TF.rtf_evd(psd_c.real)
    with pytest.raises(ValueError, match="mask"):
        TF.psd(torch.zeros(2, 4, 9, 30, dtype=torch.complex64), torch.zeros(2, 9, 29))
    with pytest.raises(ValueError, match="leading dimensions"):
        TF.apply_beamforming(torch.zeros(3, 9, 4, dtype=torch.complex64),
                             torch.zeros(2, 4, 9, 30, dtype=torch.complex64))


# --------------------------------------------------------------------------- vad

def _voiced(sr, dur=1.0, f0=150.0, amp=0.3):
    t = np.arange(int(sr * dur)) / sr
    return (amp * sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 12))).astype(np.float32)


def _quiet(sr, dur, seed, amp=0.005):
    return (amp * np.random.default_rng(seed).standard_normal(int(sr * dur))).astype(np.float32)


VAD_CASES = {
    "8k mono": (8000, lambda: np.concatenate([_quiet(8000, 1.0, 0), _voiced(8000), _quiet(8000, 0.5, 1)]), {}),
    "16k mono": (16000, lambda: np.concatenate([_quiet(16000, 1.0, 0), _voiced(16000), _quiet(16000, 0.5, 1)]), {}),
    "8k two channels, the earlier onset": (8000, lambda: np.stack([
        np.concatenate([_quiet(8000, 1.0, 4), _voiced(8000), _quiet(8000, 0.5, 5)]),
        np.concatenate([_quiet(8000, 0.5, 2), _voiced(8000), _quiet(8000, 1.0, 3)])]), {}),
    "8k no trigger": (8000, lambda: _quiet(8000, 2.0, 6), {}),
    "8k no trigger, pre-trigger 0.25 s": (8000, lambda: _quiet(8000, 2.0, 6), dict(pre_trigger_time=0.25)),
    "8k other parameters": (8000, lambda: np.concatenate([_quiet(8000, 0.8, 7), _voiced(8000, f0=200.0),
                                                          _quiet(8000, 0.2, 8)]),
                            dict(trigger_level=5.0, trigger_time=0.1, search_time=0.5, allowed_gap=0.1,
                                 measure_freq=25.0, noise_reduction_amount=1.0)),
}


@pytest.mark.parametrize("case", list(VAD_CASES))
def test_vad_matches_jax(case):
    sr, make, kw = VAD_CASES[case]
    sig = make()
    ref = np.asarray(JF.vad(jnp.asarray(sig), sr, **kw))
    got = TF.vad(torch.from_numpy(sig), sr, **kw)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    if "no trigger" not in case:  # a suffix of the recording, some of the leading noise gone
        assert 0 < got.shape[-1] < sig.shape[-1] and np.array_equal(ref, sig[..., -ref.shape[-1]:])


def test_vad_measures_match_jax():
    """The state machine's measures and trigger levels against the JAX package's scan (1e-5 abs + 1e-4 rel
    in float32), on a voiced channel and a noisy one."""
    from audio_tpu.functional._vad import _vad_measures as jax_measures

    from audio_tpu_torch.functional._vad import _vad_measures

    sr = 8000
    sig = np.stack([np.concatenate([_quiet(sr, 0.5, 9), _voiced(sr)]), _quiet(sr, 1.5, 10, amp=0.05)])
    mlen, period = 800, 400
    starts = np.arange(0, sig.shape[-1] - mlen, period)
    frames = sig[:, starts[:, None] + np.arange(mlen)]
    sw = (2.0 / np.sqrt(mlen) * np.hanning(mlen + 1)[:-1]).astype(np.float32)
    cw = (2.0 / np.sqrt(200 - 6) * np.hanning(194 + 1)[:-1]).astype(np.float32)
    args = (1024, 6, 200, 2, 26, 1.35, 0.88, 0.6, 0.0067, 0.82, 6)
    ref_m, ref_mean = jax_measures(jnp.asarray(frames), jnp.asarray(sw), jnp.asarray(cw), *args)
    got_m, got_mean = _vad_measures(torch.from_numpy(frames), torch.from_numpy(sw), torch.from_numpy(cw), *args)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(ref_mean), atol=1e-5, rtol=1e-4)
