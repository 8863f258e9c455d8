"""The port's inverse STFT and the rest of ``_spectral.py`` (CPU) against the JAX package.

``istft``, ``inverse_spectrogram``, ``griffinlim``, ``amplitude_to_DB``,
``DB_to_amplitude``, ``phase_vocoder`` and ``spectral_centroid`` take the same
seeded numpy inputs on both sides.  In float64 they agree to 1e-9 abs.  In
float32 the tolerances are the JAX package's own tests'
(tests/functional/test_spectral.py): istft 1e-5 abs + 1e-4 rel, the decibel
conversions 1e-5 (atol and rtol), Griffin-Lim by its criterion (the rebuilt
magnitude spectrogram's correlation with the target above 0.98).  The phase
vocoder accumulates a phase of up to pi hop a frame, whose float32 rounding
grows with the frame: it is held to that rounding (see its test).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audio_tpu.functional as JF

import audio_tpu_torch.functional as TF

F64 = dict(atol=1e-9, rtol=0)
DTYPES = [np.float64, np.float32]
N_FFT, HOP = 256, 64


def _ids(dt):
    return np.dtype(dt).name


def _tol(dtype, **f32):
    return F64 if dtype == np.float64 else f32


def _hann(n: int, dtype) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(dtype)


def _hamming(n: int, dtype) -> np.ndarray:
    """Non-zero at its edges: the overlap-add of its square has no hole without center padding."""
    return (0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / n)).astype(dtype)


def _signal(seed: int, shape, dtype) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(dtype)


def _complex_spec(x: np.ndarray, window: np.ndarray, center: bool = True, onesided: bool = True) -> np.ndarray:
    return np.array(JF.stft(jnp.asarray(x), N_FFT, HOP, window=jnp.asarray(window), center=center,
                            onesided=onesided))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("length", [None, 1990, 2100], ids=["no_length", "cut", "padded"])
@pytest.mark.parametrize("onesided", [True, False], ids=["onesided", "twosided"])
@pytest.mark.parametrize("center", [True, False], ids=["center", "no_center"])
def test_istft_matches_jax(center, onesided, length, dtype):
    x = _signal(0, (2, 3, 2000), dtype)
    w = (_hann if center else _hamming)(N_FFT, dtype)
    spec = _complex_spec(x, w, center, onesided)
    kw = dict(center=center, onesided=onesided, length=length)
    ref = np.asarray(JF.istft(jnp.asarray(spec), N_FFT, HOP, window=jnp.asarray(w), **kw))
    got = TF.istft(_t(spec), N_FFT, HOP, window=_t(w), **kw)
    assert got.dtype == torch.from_numpy(x).dtype and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype, atol=1e-5, rtol=1e-4))


@pytest.mark.parametrize("normalized", [False, True])
def test_istft_inverts_the_port_s_stft(normalized):
    x = torch.from_numpy(_signal(1, (3, 4000), np.float32))
    w = torch.hann_window(400)
    spec = TF.stft(x, 400, 160, window=w, normalized=normalized)
    rec = TF.istft(spec, 400, 160, window=w, normalized=normalized, length=4000)
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("normalized,pad", [(False, 0), (True, 0), ("frame_length", 0), (False, 3), ("window", 5)])
def test_inverse_spectrogram_matches_jax(normalized, pad, dtype):
    x = _signal(2, (2, 2000), dtype)
    w = _hann(N_FFT, dtype)
    spec = np.array(JF.spectrogram(jnp.asarray(x), pad=pad, window=jnp.asarray(w), n_fft=N_FFT, hop_length=HOP,
                                   power=None, normalized=normalized))
    kw = dict(pad=pad, n_fft=N_FFT, hop_length=HOP, normalized=normalized)
    ref = np.asarray(JF.inverse_spectrogram(jnp.asarray(spec), 2000, window=jnp.asarray(w), **kw))
    got = TF.inverse_spectrogram(_t(spec), 2000, window=_t(w), **kw)
    assert tuple(got.shape) == ref.shape == (2, 2000)
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype, atol=1e-5, rtol=1e-4))
    covered = HOP * ((2000 + 2 * pad) // HOP) - pad  # the frames' centres reach this far; past it zeros
    np.testing.assert_allclose(got.numpy()[:, :covered], x[:, :covered], atol=1e-5 if dtype == np.float32 else 1e-9)


def test_inverse_spectrogram_raises_on_a_real_input():
    with pytest.raises(ValueError, match="complex"):
        TF.inverse_spectrogram(torch.zeros(129, 10), 2000, n_fft=N_FFT)


def _tone_spec(dtype, n: int = 4000):
    """Power spectrogram of a decaying two-tone signal, and the window."""
    t = np.arange(n) / 16000
    x = (np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 1234 * t)) * np.exp(-t)
    w = _hann(N_FFT, dtype)
    spec = np.array(JF.spectrogram(jnp.asarray(x.astype(dtype)), window=jnp.asarray(w), n_fft=N_FFT,
                                   hop_length=HOP, power=2.0))
    return spec, w, n


def _correlation(rec: torch.Tensor, spec: np.ndarray, w: np.ndarray) -> float:
    """The JAX test's criterion: the rebuilt magnitude spectrogram against the target's."""
    got = TF.spectrogram(rec.double(), window=_t(w).double(), n_fft=N_FFT, hop_length=HOP, power=1.0).numpy()
    return float(np.corrcoef(got.ravel(), np.sqrt(spec).ravel())[0, 1])


def test_griffinlim_matches_jax_without_rand_init():
    """float64, rand_init=False, 32 iterations at momentum 0.99: the same waveform to 1e-9 on a
    noise signal's spectrogram.  A tone's spectrogram has bins of almost no magnitude, whose phase
    (rebuilt / |rebuilt|) turns on the last bits of the two sides' FFTs: there the two agree to
    7e-13 after one iteration and to 2.2e-8 of a peak of 1.45 after 32 (measured on this input), so
    that case is held to 1e-6 of the peak, the tolerance of the card against the CPU."""
    x = _signal(8, (4000,), np.float64)
    w = _hann(N_FFT, np.float64)
    cases = ((np.array(JF.spectrogram(jnp.asarray(x), window=jnp.asarray(w), n_fft=N_FFT, hop_length=HOP)), F64),
             (_tone_spec(np.float64)[0], None))
    for spec, tol in cases:
        kw = dict(n_fft=N_FFT, hop_length=HOP, power=2.0, n_iter=32, momentum=0.99, length=4000, rand_init=False)
        ref = np.asarray(JF.griffinlim(jnp.asarray(spec), window=jnp.asarray(w), **kw))
        got = TF.griffinlim(_t(spec), window=_t(w), **kw)
        assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape == (4000,)
        np.testing.assert_allclose(got.numpy(), ref, **(tol or dict(atol=1e-6 * np.abs(ref).max(), rtol=0)))


@pytest.mark.parametrize("rand_init", [False, True], ids=["ones", "random"])
def test_griffinlim_float32_meets_the_correlation_criterion(rand_init):
    spec, w, n = _tone_spec(np.float32)
    rec = TF.griffinlim(_t(spec), window=_t(w), n_fft=N_FFT, hop_length=HOP, power=2.0, n_iter=32, length=n,
                        rand_init=rand_init, generator=torch.Generator().manual_seed(3))
    assert rec.dtype == torch.float32 and rec.shape == (n,)
    assert _correlation(rec, spec, w) > 0.98


def test_griffinlim_draws_from_its_generator():
    """rand_init draws the real then the imaginary parts uniformly from the generator; None stands for
    a generator seeded 0; half precision computes in float32 and casts back."""
    spec, w, n = _tone_spec(np.float32)
    kw = dict(window=_t(w), n_fft=N_FFT, hop_length=HOP, n_iter=2, length=n)
    a = TF.griffinlim(_t(spec), generator=torch.Generator().manual_seed(0), **kw)
    assert torch.equal(a, TF.griffinlim(_t(spec), **kw))
    assert not torch.equal(a, TF.griffinlim(_t(spec), generator=torch.Generator().manual_seed(1), **kw))
    g = torch.Generator().manual_seed(5)
    re, im = torch.rand(spec.shape, generator=g), torch.rand(spec.shape, generator=g)
    mag = _t(spec) ** 0.5
    angles = torch.complex(re, im)
    m = 0.99 / 1.99
    tprev = torch.zeros_like(angles)
    for _ in range(2):
        inv = TF.istft(mag * angles, N_FFT, HOP, window=_t(w), length=n)
        rebuilt = TF.stft(inv, N_FFT, HOP, window=_t(w))
        angles = rebuilt - tprev * m
        angles = angles / (angles.abs() + 1e-16)
        tprev = rebuilt
    want = TF.istft(mag * angles, N_FFT, HOP, window=_t(w), length=n)
    assert torch.equal(TF.griffinlim(_t(spec), generator=torch.Generator().manual_seed(5), **kw), want)
    half = TF.griffinlim(_t(spec).half(), generator=torch.Generator().manual_seed(0), **kw)
    f32 = TF.griffinlim(_t(spec).half().float(), generator=torch.Generator().manual_seed(0), **kw)
    assert half.dtype == torch.float16 and torch.equal(half, f32.half())


def test_griffinlim_raises_on_momentum_outside_0_1():
    with pytest.raises(ValueError, match="momentum"):
        TF.griffinlim(torch.ones(129, 5), n_fft=N_FFT, momentum=1.0)
    with pytest.raises(ValueError, match="momentum"):
        TF.griffinlim(torch.ones(129, 5), n_fft=N_FFT, momentum=-0.1)


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("top_db", [None, 80.0], ids=["no_top_db", "top_db80"])
@pytest.mark.parametrize("shape", [(129, 40), (2, 129, 40), (3, 2, 129, 20)], ids=["2d", "3d", "4d"])
def test_amplitude_to_DB_matches_jax(shape, top_db, dtype):
    rng = np.random.default_rng(len(shape))
    x = (np.abs(rng.standard_normal(shape)) ** 4 * np.exp(-rng.uniform(0, 30, shape))).astype(dtype)
    args = (10.0, 1e-10, 0.5, top_db)
    ref = np.asarray(JF.amplitude_to_DB(jnp.asarray(x), *args))
    got = TF.amplitude_to_DB(_t(x), *args)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype, atol=1e-5, rtol=1e-5))
    if top_db is not None:  # the floor is each clip's own: over the last three axes
        clips = got.reshape((-1,) + ((shape[-3],) if len(shape) > 2 else (1,)) + shape[-2:])
        floor = clips.amax(dim=(-3, -2, -1)) - top_db
        assert torch.equal(clips.amin(dim=(-3, -2, -1)), floor.to(got.dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
def test_DB_to_amplitude_matches_jax(dtype):
    x = np.random.default_rng(4).uniform(-80, 10, (2, 129, 30)).astype(dtype)
    for ref_, power in ((1.0, 1.0), (2.0, 0.5)):
        ref = np.asarray(JF.DB_to_amplitude(jnp.asarray(x), ref_, power))
        got = TF.DB_to_amplitude(_t(x), ref_, power)
        np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype, atol=1e-5, rtol=1e-5))
    back = TF.DB_to_amplitude(TF.amplitude_to_DB(_t(np.abs(x) + 1e-3), 10.0, 1e-10, 0.0), 1.0, 1.0)
    np.testing.assert_allclose(back.numpy(), np.abs(x) + 1e-3, rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("rate", [0.8, 1.0, 1.3])
def test_phase_vocoder_matches_jax(rate, dtype):
    """ceil(T / rate) frames.  float64 to 1e-9.  In float32 each output's phase is a running sum of
    up to pi hop + 2 pi a frame, which both sides round (in another order): frame j may differ by
    |ref| eps_f32 (j + 1) (pi hop + 2 pi), four times that being allowed, plus 1e-5."""
    x = _signal(5, (2, 4000), dtype)
    spec = _complex_spec(x, _hann(N_FFT, dtype))
    advance = np.linspace(0, math.pi * HOP, N_FFT // 2 + 1)[:, None].astype(dtype)
    ref = np.asarray(JF.phase_vocoder(jnp.asarray(spec), rate, jnp.asarray(advance)))
    got = TF.phase_vocoder(_t(spec), rate, _t(advance))
    assert got.dtype == torch.from_numpy(spec).dtype
    assert got.shape[-1] == math.ceil(spec.shape[-1] / rate) == ref.shape[-1]
    if dtype == np.float64:
        np.testing.assert_allclose(got.numpy(), ref, **F64)
    else:
        frames = np.arange(1, ref.shape[-1] + 1)
        bound = 1e-5 + 4 * np.abs(ref) * np.finfo(np.float32).eps * frames * (math.pi * HOP + 2 * math.pi)
        assert (np.abs(got.numpy() - ref) <= bound).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
def test_spectral_centroid_matches_jax(dtype):
    x = _signal(6, (2, 3, 3000), dtype)
    w = _hann(N_FFT, dtype)
    ref = np.asarray(JF.spectral_centroid(jnp.asarray(x), 16000, 0, jnp.asarray(w), N_FFT, HOP, N_FFT))
    got = TF.spectral_centroid(_t(x), 16000, 0, _t(w), N_FFT, HOP, N_FFT)
    assert got.dtype == torch.from_numpy(x).dtype and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype, atol=0, rtol=1e-4))


def test_spectral_centroid_in_float16_reduces_in_float32():
    """The weighted sum reaches Hz x magnitude scale past float16's 65504: the port sums in float32
    and casts back, as the JAX package; the same centroid as JAX's float16 one."""
    x = _signal(7, (2, 3000), np.float16) * 40
    w = _hann(N_FFT, np.float16)
    got = TF.spectral_centroid(_t(x), 16000, 0, _t(w), N_FFT, HOP, N_FFT)
    ref = np.asarray(JF.spectral_centroid(jnp.asarray(x), 16000, 0, jnp.asarray(w), N_FFT, HOP, N_FFT))
    assert got.dtype == torch.float16 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().numpy(), ref.astype(np.float32), rtol=2e-3)
    spec = TF.spectrogram(_t(x), window=_t(w), n_fft=N_FFT, hop_length=HOP, power=1.0)
    freqs = torch.linspace(0, 8000, N_FFT // 2 + 1, dtype=torch.float16)
    assert not bool(torch.isfinite(torch.sum(freqs[:, None] * spec, dim=-2)).all())  # what float16 would give
