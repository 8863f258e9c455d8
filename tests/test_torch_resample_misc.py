"""The port's resampling and miscellaneous ops (CPU) against the JAX package.

The same seeded numpy inputs go through ``audio_tpu.functional`` (x64 on, as
``tests/conftest.py`` sets it) and ``audio_tpu_torch.functional``.  In float64
the two agree to 1e-9 abs, the Frechet distance aside (both cast its
eigenvalues to complex64: 1e-4 abs, the JAX test's).  In float32 the
tolerances are the JAX package's own tests' where they have one
(tests/functional/test_misc.py: compute_deltas 1e-6 abs, preemphasis 1e-7
abs, loudness 0.01 LKFS, frechet_distance 1e-4 abs), else 1e-5 abs + 1e-4
rel.  Loudness needs the JAX test's 0.01: the 38 Hz highpass's pole near 1
amplifies float32 rounding, and at 48 kHz the two packages' float32 results
lie 1.1e-3 (the port) and 2.6e-3 LKFS (the JAX package) from their shared
float64 one.  Integer
outputs are equal: mu-law codes, edit distances, speed's lengths, and the lag
each frame's pitch comes from.  The masks draw from a ``torch.Generator``
where the JAX package takes a key: the JAX function is run on the port's own
draws (its ``jax.random.uniform`` replaced by them), and must give the same
spectrogram.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audio_tpu.functional as JF
from audio_tpu.functional import _misc as jax_misc
from audio_tpu.functional import _resample as jax_resample

import audio_tpu_torch.functional as TF
from audio_tpu_torch.functional import _misc as tf_misc
from audio_tpu_torch.functional import _resample as tf_resample

F64 = dict(atol=1e-9, rtol=0)
F32 = dict(atol=1e-5, rtol=1e-4)
DTYPES = [np.float64, np.float32]


def _ids(dt):
    return np.dtype(dt).name


def _tol(dtype, **f32):
    return F64 if dtype == np.float64 else (f32 or F32)


def _noise(seed: int, shape, dtype, scale: float = 0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(dtype)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tones(seed: int, rows: int, n: int, sr: int, dtype) -> np.ndarray:
    """Rows of a harmonic tone (100-400 Hz fundamental, five harmonics) in a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 400, (rows, 1))
    x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6, (rows, 1))) / h for h in range(1, 6))
    return (0.3 * x + 0.01 * rng.standard_normal((rows, n))).astype(dtype)


# --------------------------------------------------------------------------- resample

KERNELS = {
    "16k-8k hann": (16000, 8000, 6, 0.99, "sinc_interp_hann", None),
    "44.1k-16k kaiser": (44100, 16000, 6, 0.99, "sinc_interp_kaiser", None),
    "16k-44.1k kaiser beta 8, width 16": (16000, 44100, 16, 0.945, "sinc_interp_kaiser", 8.0),
}


@pytest.mark.parametrize("case", list(KERNELS))
def test_sinc_resample_kernel_is_the_jax_package_s(case):
    """The same numpy float64 construction: equal, then cast to the requested type on the host."""
    orig, new, width, rolloff, method, beta = KERNELS[case]
    ref, ref_w = jax_resample.get_sinc_resample_kernel(orig, new, None, width, rolloff, method, beta,
                                                       dtype=jnp.float64)
    got, got_w = tf_resample.get_sinc_resample_kernel(orig, new, None, width, rolloff, method, beta,
                                                      dtype=torch.float64)
    assert got_w == ref_w and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    f32, _ = tf_resample.get_sinc_resample_kernel(orig, new, None, width, rolloff, method, beta)
    assert f32.dtype == torch.float32 and torch.equal(f32, got.float())


RESAMPLES = {
    "16k-8k": (16000, 8000, {}),
    "8k-16k": (8000, 16000, {}),
    "48k-16k": (48000, 16000, {}),
    "16k-44.1k kaiser": (16000, 44100, dict(resampling_method="sinc_interp_kaiser")),
    "16k-8k width 16 rolloff 0.945": (16000, 8000, dict(lowpass_filter_width=16, rolloff=0.945)),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("case", list(RESAMPLES))
def test_resample_matches_jax(case, dtype):
    orig, new, kw = RESAMPLES[case]
    x = _noise(1, (2, 3, 1200), dtype)
    ref = np.asarray(JF.resample(jnp.asarray(x), orig, new, **kw))
    got = TF.resample(_t(x), orig, new, **kw)
    assert got.dtype == _t(x).dtype and tuple(got.shape) == ref.shape == (2, 3, math.ceil(1200 * new / orig))
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype))


def test_resample_keeps_a_cosine_and_returns_the_input_at_equal_rates():
    """The JAX package's analytic oracle (2e-3 away from the edges), and the identity."""
    orig, new = 48000, 16000
    x = np.cos(2 * np.pi * 440.0 * np.arange(orig) / orig).astype(np.float32)
    y = TF.resample(_t(x), orig, new).numpy()
    want = np.cos(2 * np.pi * 440.0 * np.arange(y.shape[-1]) / new)
    assert np.abs(y[200:-200] - want[200:-200]).max() < 2e-3
    xt = _t(x)
    assert TF.resample(xt, orig, orig) is xt


def test_apply_sinc_resample_kernel_raises_as_the_jax_package():
    kernel, width = tf_resample.get_sinc_resample_kernel(2, 1)
    with pytest.raises(TypeError, match="floating point"):
        tf_resample.apply_sinc_resample_kernel(torch.zeros(10, dtype=torch.int32), 2, 1, 1, kernel, width)
    with pytest.raises(ValueError, match="positive"):
        TF.resample(torch.zeros(10), 0, 16000)
    with pytest.raises(ValueError, match="Invalid resampling method"):
        tf_resample.get_sinc_resample_kernel(2, 1, resampling_method="linear")


# --------------------------------------------------------------------------- mu-law

@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("channels", [256, 16])
def test_mu_law_matches_jax(channels, dtype):
    """The codes equal the JAX package's; decoding them agrees in the input's type."""
    x = np.clip(_noise(2, (3, 2000), dtype, scale=0.4), -1, 1)
    ref = np.asarray(JF.mu_law_encoding(jnp.asarray(x), channels))
    got = TF.mu_law_encoding(_t(x), channels)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_dec = np.asarray(JF.mu_law_decoding(jnp.asarray(ref.astype(dtype)), channels))
    got_dec = TF.mu_law_decoding(_t(ref.astype(dtype)), channels)
    np.testing.assert_allclose(got_dec.numpy(), ref_dec, **_tol(dtype))
    # integer codes decode in float32, as the JAX package's
    assert TF.mu_law_decoding(got, channels).dtype == torch.float32


# --------------------------------------------------------------------------- SpecAugment masks

def _jax_on_torch_draws(monkeypatch, draws):
    """Replace jax.random.uniform by the port's draws, in the order the JAX function asks."""
    queue = [jnp.asarray(d.numpy()) for d in draws]
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: queue.pop(0))
    return queue


@pytest.mark.parametrize("axis", [1, 2])
def test_mask_along_axis_matches_jax_on_the_same_draws(monkeypatch, axis):
    x = _noise(3, (2, 40, 60), np.float32)
    g = torch.Generator().manual_seed(4)
    got = TF.mask_along_axis(_t(x), 20, -1.0, axis, generator=g)
    g2 = torch.Generator().manual_seed(4)
    draws = [torch.rand((), generator=g2), torch.rand((), generator=g2)]
    queue = _jax_on_torch_draws(monkeypatch, draws)
    ref = np.asarray(JF.mask_along_axis(jnp.asarray(x), 20, -1.0, axis, key=jax.random.PRNGKey(0)))
    assert not queue
    np.testing.assert_array_equal(got.numpy(), ref)
    masked = (got == -1.0).all(dim=0).all(dim=2 - axis)
    assert 0 < int(masked.sum()) <= 20
    assert torch.equal(got[0] == -1.0, got[1] == -1.0)  # one span for every example


@pytest.mark.parametrize("axis", [2, 3])
def test_mask_along_axis_iid_matches_jax_on_the_same_draws(monkeypatch, axis):
    x = _noise(5, (4, 2, 30, 50), np.float32)
    fill = torch.tensor(0.5)
    got = TF.mask_along_axis_iid(_t(x), 25, fill, axis, generator=torch.Generator().manual_seed(6))
    g = torch.Generator().manual_seed(6)
    draws = [torch.rand((4, 2), generator=g), torch.rand((4, 2), generator=g)]
    _jax_on_torch_draws(monkeypatch, draws)
    ref = np.asarray(JF.mask_along_axis_iid(jnp.asarray(x), 25, jnp.asarray(0.5), axis, key=jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(got.numpy(), ref)
    spans = {int((got[b, c] == 0.5).all(dim=3 - axis).sum()) for b in range(4) for c in range(2)}
    assert len(spans) > 1 and max(spans) <= 25  # independent draws


def test_masks_without_a_generator_draw_from_seed_0_and_follow_p():
    x = _t(_noise(7, (3, 2, 30, 40), np.float32))
    assert torch.equal(TF.mask_along_axis(x, 10, 0.0, 3),
                       TF.mask_along_axis(x, 10, 0.0, 3, generator=torch.Generator().manual_seed(0)))
    assert torch.equal(TF.mask_along_axis_iid(x, 10, 0.0, 2),
                       TF.mask_along_axis_iid(x, 10, 0.0, 2, generator=torch.Generator().manual_seed(0)))
    # p caps mask_param at p * size; below 1 nothing is masked and nothing is drawn
    assert (TF.mask_along_axis(x, 100, 0.0, 3, p=0.1) == 0).all(dim=2).sum(dim=-1).max() <= 4
    assert TF.mask_along_axis_iid(x, 10, 0.0, 3, p=0.01) is x
    for bad in (lambda: TF.mask_along_axis(x[0, 0, 0], 5, 0.0, 0), lambda: TF.mask_along_axis(x, 5, 0.0, 1),
                lambda: TF.mask_along_axis_iid(x[0, 0], 5, 0.0, 1), lambda: TF.mask_along_axis(x, 5, 0.0, 3, p=2.0)):
        with pytest.raises(ValueError):
            bad()


# --------------------------------------------------------------------------- deltas, pitch, CMN

@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("mode,win", [("replicate", 5), ("constant", 7), ("reflect", 3)])
def test_compute_deltas_matches_jax(mode, win, dtype):
    x = _noise(8, (2, 3, 20, 37), dtype, scale=1.0)
    ref = np.asarray(JF.compute_deltas(jnp.asarray(x), win, mode))
    got = TF.compute_deltas(_t(x), win, mode)
    assert got.dtype == _t(x).dtype
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype, atol=1e-6, rtol=0))


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
def test_detect_pitch_frequency_matches_jax(dtype, monkeypatch):
    """Each frame's lag equal to the JAX package's (argmax's first index, the 0.99 rule, the lower
    median); the NCCF within 1e-4 relative.  With lagged frames one row at a time, the same bits."""
    sr = 16000
    x = _tones(9, 6, 4000, sr, dtype).reshape(2, 3, 4000)
    ref = np.asarray(JF.detect_pitch_frequency(jnp.asarray(x), sr))
    got = TF.detect_pitch_frequency(_t(x), sr)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)

    flat = x.reshape(6, 4000)
    nccf_ref = np.asarray(jax_misc._compute_nccf(jnp.asarray(flat), sr, 1e-2, 85))
    nccf = tf_misc._compute_nccf(_t(flat), sr, 1e-2, 85)
    np.testing.assert_allclose(nccf.numpy(), nccf_ref, **_tol(dtype))
    monkeypatch.setattr(tf_misc, "_NCCF_BLOCK_ELEMENTS", 1)
    assert torch.equal(tf_misc._compute_nccf(_t(flat), sr, 1e-2, 85), nccf)


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("center", [False, True], ids=["causal", "centered"])
@pytest.mark.parametrize("norm_vars", [False, True], ids=["mean", "mean_var"])
def test_sliding_window_cmn_matches_jax(center, norm_vars, dtype):
    x = _noise(10, (2, 130, 13), dtype, scale=2.0) + 1.0
    kw = dict(cmn_window=40, min_cmn_window=10, center=center, norm_vars=norm_vars)
    ref = np.asarray(JF.sliding_window_cmn(jnp.asarray(x), **kw))
    got = TF.sliding_window_cmn(_t(x), **kw)
    assert got.dtype == _t(x).dtype
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype))


@pytest.mark.parametrize("s1,s2", [("abc", "abc"), ("abc", ""), ("", "abc"), ("kitten", "sitting"), ("aaa", "aba"),
                                   (["hello", "world"], ["hello", "there", "world"]), ([1, 2, 3, 4], [4, 3, 2, 1])])
def test_edit_distance_matches_jax(s1, s2):
    assert TF.edit_distance(s1, s2) == JF.edit_distance(s1, s2)


# --------------------------------------------------------------------------- loudness, pitch shift

@pytest.mark.parametrize("sr,channels,dtype", [(16000, 5, np.float64), (48000, 2, np.float32)],
                         ids=["16k-5ch-float64", "48k-2ch-float32"])
def test_loudness_matches_jax(sr, channels, dtype):
    """Through the port's treble and 38 Hz highpass biquads (a pole near 1, so 48 kHz too); five
    channels take the surround weights."""
    x = _tones(11, 2 * channels, sr, sr, dtype).reshape(2, channels, sr)
    x[1] *= 0.05  # a quiet row
    ref = np.asarray(JF.loudness(jnp.asarray(x), sr))
    got = TF.loudness(_t(x), sr)
    assert got.dtype == _t(x).dtype and tuple(got.shape) == ref.shape == (2,)
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype, atol=0.01, rtol=0))


def test_loudness_measures_half_precision_in_float32():
    x = _t(_tones(12, 2, 16000, 16000, np.float32)).reshape(2, 1, 16000)
    got = TF.loudness(x.to(torch.bfloat16), 16000)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, TF.loudness(x.to(torch.bfloat16).float(), 16000).to(torch.bfloat16))
    with pytest.raises(ValueError, match="5 channels"):
        TF.loudness(torch.zeros(1, 6, 16000), 16000)


@pytest.mark.parametrize("n_steps,dtype", [(12, np.float64), (-12, np.float64), (12, np.float32)],
                         ids=["+12-float64", "-12-float64", "+12-float32"])
def test_pitch_shift_matches_jax(n_steps, dtype):
    """An octave either way: the resampling kernel is then 1 x 14 or 2 x 27 (gcd(2 sr, sr) = sr);
    other steps build kernels of millions of entries on the host (16,000 x 17,973 at 2 steps), in
    both packages alike.  float64 to 1e-9; in float32 the JAX package (x64 on) takes the phase
    advance in float64, the port in float32, whose rounding of the accumulated phase, up to
    pi hop + 2 pi a frame, bounds the difference: 4 eps_f32 frames (pi hop + 2 pi) max|x|."""
    sr, n, hop = 16000, 2000, 128
    x = _tones(13, 2, n, sr, dtype)
    ref = np.asarray(JF.pitch_shift(jnp.asarray(x), sr, n_steps))
    got = TF.pitch_shift(_t(x), sr, n_steps)
    assert got.dtype == _t(x).dtype and tuple(got.shape) == ref.shape == x.shape
    if dtype == np.float64:
        np.testing.assert_allclose(got.numpy(), ref, **F64)
    else:
        frames = n * 2 // hop + 2
        bound = 4 * np.finfo(np.float32).eps * frames * (math.pi * hop + 2 * math.pi) * np.abs(x).max()
        np.testing.assert_allclose(got.numpy(), ref, atol=bound, rtol=0)


def test_pitch_shift_in_half_precision_computes_in_float32():
    x = _t(_tones(14, 2, 2000, 16000, np.float32))
    got = TF.pitch_shift(x.half(), 16000, 12)
    assert got.dtype == torch.float16
    assert torch.equal(got, TF.pitch_shift(x.half().float(), 16000, 12).half())


# --------------------------------------------------------------------------- convolution, noise, speed, emphasis

@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("mode", ["full", "valid", "same"])
@pytest.mark.parametrize("name", ["convolve", "fftconvolve"])
def test_convolutions_match_jax(name, mode, dtype):
    """x (2, 3, 50) with y (1, 3, 11) broadcast over the batch, and the operands swapped."""
    x = _noise(15, (2, 3, 50), dtype, scale=1.0)
    y = _noise(16, (1, 3, 11), dtype, scale=1.0)
    for a, b in ((x, y), (y, x)):
        ref = np.asarray(getattr(JF, name)(jnp.asarray(a), jnp.asarray(b), mode))
        got = getattr(TF, name)(_t(a), _t(b), mode)
        assert got.dtype == _t(a).dtype and tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype))


def test_convolutions_raise_as_the_jax_package_and_fftconvolve_upcasts_half():
    with pytest.raises(ValueError, match="same dimension"):
        TF.convolve(torch.zeros(2, 5), torch.zeros(5))
    with pytest.raises(ValueError, match="broadcastable"):
        TF.fftconvolve(torch.zeros(2, 5), torch.zeros(3, 5))
    with pytest.raises(ValueError, match="Unrecognized mode"):
        TF.convolve(torch.zeros(2, 5), torch.zeros(2, 3), "circular")
    x, y = _t(_noise(17, (2, 40), np.float32)), _t(_noise(18, (2, 5), np.float32))
    got = TF.fftconvolve(x.bfloat16(), y.bfloat16())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, TF.fftconvolve(x.bfloat16().float(), y.bfloat16().float()).bfloat16())


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("with_lengths", [False, True], ids=["whole", "lengths"])
def test_add_noise_matches_jax(with_lengths, dtype):
    x = _noise(19, (2, 3, 500), dtype)
    noise = _noise(20, (2, 3, 500), dtype, scale=0.1)
    snr = np.asarray([[0.0, 10.0, 20.0], [5.0, 15.0, 3.0]], dtype)
    lengths = np.asarray([[500, 400, 250], [100, 500, 321]]) if with_lengths else None
    ref = np.asarray(JF.add_noise(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(snr),
                                  None if lengths is None else jnp.asarray(lengths)))
    got = TF.add_noise(_t(x), _t(noise), _t(snr), None if lengths is None else _t(lengths))
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype))
    with pytest.raises(ValueError, match="leading dimensions"):
        TF.add_noise(_t(x), _t(noise), _t(snr[0]))


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("factor", [1.1, 0.9])
def test_speed_matches_jax(factor, dtype):
    x = _noise(21, (3, 1600), dtype)
    lengths = np.asarray([1600, 1234, 11])
    ref, ref_len = JF.speed(jnp.asarray(x), 16000, factor, jnp.asarray(lengths))
    got, got_len = TF.speed(_t(x), 16000, factor, _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **_tol(dtype))
    assert got_len.dtype == torch.int64
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    float_len = TF.speed(_t(x), 16000, factor, _t(lengths.astype(dtype)))[1]
    np.testing.assert_array_equal(float_len.numpy(), np.asarray(JF.speed(jnp.asarray(x), 16000, factor,
                                                                         jnp.asarray(lengths.astype(dtype)))[1]))
    assert TF.speed(_t(x), 16000, factor)[1] is None


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("coeff", [0.97, 0.5])
def test_pre_and_deemphasis_match_jax(coeff, dtype):
    """preemphasis against the JAX package to the JAX test's 1e-7; deemphasis (lfilter, clamped)
    against it in float64, and in float32 against the recurrence y[i] = x[i] + coeff y[i-1] run in
    float64 (1e-5 abs + 1e-4 rel: a float32 JAX lfilter compiles for another 4 s a shape)."""
    x = _noise(22, (2, 3, 600), dtype, scale=0.15)
    pre = TF.preemphasis(_t(x), coeff)
    np.testing.assert_allclose(pre.numpy(), np.asarray(JF.preemphasis(jnp.asarray(x), coeff)),
                               **_tol(dtype, atol=1e-7, rtol=0))
    de = TF.deemphasis(pre, coeff)
    if dtype == np.float64:
        np.testing.assert_allclose(de.numpy(), np.asarray(JF.deemphasis(jnp.asarray(pre.numpy()), coeff)), **F64)
    else:
        p64, want = pre.numpy().astype(np.float64), np.zeros(pre.shape)
        for i in range(p64.shape[-1]):
            want[..., i] = p64[..., i] + (coeff * want[..., i - 1] if i else 0.0)
        np.testing.assert_allclose(de.numpy(), np.clip(want, -1, 1), **F32)
    np.testing.assert_allclose(de.numpy(), x, atol=1e-5)  # the round trip


# --------------------------------------------------------------------------- Frechet distance

@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
def test_frechet_distance_matches_jax(dtype):
    """Both cast the eigenvalues of Sx Sy to complex64 before the square root: 1e-4 abs (the JAX
    test's) in both types."""
    rng = np.random.default_rng(23)
    a, b = rng.standard_normal((2, 16, 16))
    args = [rng.standard_normal(16), a @ a.T / 16 + np.eye(16), rng.standard_normal(16), b @ b.T / 16 + np.eye(16)]
    args = [v.astype(dtype) for v in args]
    ref = float(JF.frechet_distance(*map(jnp.asarray, args)))
    got = TF.frechet_distance(*map(_t, args))
    assert got.dtype == _t(args[0]).dtype and got.dim() == 0
    np.testing.assert_allclose(float(got), ref, atol=1e-4, rtol=0)
    same = TF.frechet_distance(_t(args[0]), _t(args[1]), _t(args[0]), _t(args[1]))
    assert abs(float(same)) < 1e-3
    half = TF.frechet_distance(*(_t(v).half() for v in args))
    assert half.dtype == torch.float16
    with pytest.raises(ValueError, match="one-dimensional"):
        TF.frechet_distance(_t(args[1]), _t(args[1]), _t(args[2]), _t(args[3]))
