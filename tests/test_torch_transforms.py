"""The port's transform classes (CPU) against the JAX package's.

Every class of ``audio_tpu.transforms`` is built with the same arguments on
both sides (the port's on ``device="cpu"``) and called on the same seeded
numpy inputs, about 2 x 2000 samples as the JAX package's dtype matrix uses;
JAX runs with x64 on (``tests/conftest.py``).  Tolerances are the JAX
package's own tests' where they give one: the mel spectrogram's 1e-4 abs +
1e-3 rel (``tests/transforms/test_transforms.py``), loudness 0.01 LKFS,
preemphasis 1e-7 abs, deltas 1e-6 abs; else the port's float32 1e-5 abs +
1e-4 rel, taken relative to the output's peak for the dB-scaled cepstra
(MFCC, LFCC) and the complex outputs.  Integer outputs are equal: mu-law
codes, ``Speed``'s lengths, ``Vad``'s trimmed length.  The random classes
draw from a ``torch.Generator`` where the JAX package takes a key: the JAX
class runs on the port's own draws (``jax.random.uniform`` or ``randint``
replaced by them, in the order it asks).

``TimeStretch``'s ``phase_advance`` is torchaudio's float32 buffer, where the
JAX package's is float64 under x64: on complex64 input the phase vocoder
then sums the same float32 advances on both sides' float32 angles, so the
two agree at the float32 tolerance; the test compares values, not the
buffer's dtype.  The half-precision contract of the JAX dtype matrix holds
for the port too: the output's dtype follows the input's, within the same
dtype-scaled tolerance of the float32 result.
"""

import functools
import inspect
import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audio_tpu.transforms as JT

import audio_tpu_torch.transforms as TT

from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

SR = 16000
F32 = dict(atol=1e-5, rtol=1e-4)
CPU = {"device": "cpu"}


def _wave(shape=(2, 2000), seed=0, scale=0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _peak_close(got, ref, tol=F32):
    """|got - ref| within tol, both taken relative to the reference's peak."""
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    peak = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got / peak, ref / peak, **tol)


def _both(make):
    """The JAX object and the port's, from one factory ``make(T, dev)``."""
    return make(JT, {}), make(TT, CPU)


def _jit(fn, *args):
    """``fn(*args)`` under ``jax.jit`` (array arguments): one compile in place of an op-by-op run's
    hundreds, which keeps the file's time down."""
    return jax.jit(lambda *a: fn(*a))(*(jnp.asarray(a) for a in args))


# --------------------------------------------------------------------------- one waveform in, one tensor out

WAVE = _wave()
SPEC = np.abs(_wave((2, 129, 10), seed=1)).astype(np.float32)  # a power spectrogram's layout
FEATS = _wave((2, 40, 50), seed=2)

CASES = {
    # name: (factory, input, tolerance, compare relative to the peak)
    "Spectrogram power 2": (lambda T, d: T.Spectrogram(n_fft=256, hop_length=128, **d), WAVE, F32, False),
    "Spectrogram power 1 normalized": (lambda T, d: T.Spectrogram(n_fft=256, hop_length=128, power=1.0,
                                                                  normalized=True, **d), WAVE, F32, False),
    "Spectrogram complex": (lambda T, d: T.Spectrogram(n_fft=256, hop_length=64, power=None, **d), WAVE, F32, True),
    "Spectrogram power 3, n_fft 200 win 160, pad 5": (
        lambda T, d: T.Spectrogram(n_fft=200, win_length=160, hop_length=50, pad=5, power=3.0, **d), WAVE, F32, True),
    "MelSpectrogram": (lambda T, d: T.MelSpectrogram(sample_rate=SR, n_fft=256, hop_length=128, n_mels=23, **d),
                       WAVE, dict(atol=1e-4, rtol=1e-3), False),
    "MelSpectrogram power 1, slaney": (
        lambda T, d: T.MelSpectrogram(sample_rate=SR, n_fft=256, hop_length=128, n_mels=23, power=1.0, norm="slaney",
                                      mel_scale="slaney", **d), WAVE, dict(atol=1e-4, rtol=1e-3), False),
    "MelScale": (lambda T, d: T.MelScale(n_mels=23, sample_rate=SR, n_stft=129, **d), SPEC, F32, False),
    "MFCC": (lambda T, d: T.MFCC(sample_rate=SR, n_mfcc=13, melkwargs={"n_fft": 256, "hop_length": 128,
                                                                         "n_mels": 23}, **d), WAVE, F32, True),
    "MFCC log_mels": (lambda T, d: T.MFCC(sample_rate=SR, n_mfcc=13, log_mels=True, melkwargs={
        "n_fft": 256, "hop_length": 128, "n_mels": 23}, **d), WAVE, F32, True),
    "LFCC": (lambda T, d: T.LFCC(sample_rate=SR, n_lfcc=13, speckwargs={"n_fft": 256, "hop_length": 128}, **d),
             WAVE, F32, True),
    "LFCC log_lf, 40 filters": (lambda T, d: T.LFCC(sample_rate=SR, n_filter=40, n_lfcc=20, log_lf=True, f_min=50.0,
                                                    speckwargs={"n_fft": 256, "hop_length": 128}, **d),
                                WAVE, F32, True),
    "AmplitudeToDB power top_db 80": (lambda T, d: T.AmplitudeToDB("power", 80.0), SPEC, F32, False),
    "AmplitudeToDB magnitude": (lambda T, d: T.AmplitudeToDB("magnitude"), SPEC, F32, False),
    "MuLawDecoding": (lambda T, d: T.MuLawDecoding(256), np.arange(256, dtype=np.int32)[None], F32, False),
    "Resample 16k -> 8k": (lambda T, d: T.Resample(SR, 8000, **d), WAVE, F32, False),
    "Resample 16k -> 12k kaiser": (lambda T, d: T.Resample(SR, 12000, "sinc_interp_kaiser", 8, 0.95, 6.0, **d),
                                   WAVE, F32, False),
    "Resample 16k -> 16k": (lambda T, d: T.Resample(SR, SR, **d), WAVE, dict(atol=0, rtol=0), False),
    "ComputeDeltas": (lambda T, d: T.ComputeDeltas(), FEATS, dict(atol=1e-6, rtol=0), False),
    "ComputeDeltas 7 reflect": (lambda T, d: T.ComputeDeltas(7, "reflect"), FEATS, dict(atol=1e-6, rtol=0), False),
    "Loudness": (lambda T, d: T.Loudness(SR), _wave((2, 6400), seed=3), dict(atol=0.01, rtol=0), False),
    "Vol amplitude": (lambda T, d: T.Vol(2.0), WAVE, F32, False),
    "Vol db": (lambda T, d: T.Vol(6.0, "db"), WAVE, F32, False),
    "Vol power": (lambda T, d: T.Vol(4.0, "power"), WAVE, F32, False),
    "SlidingWindowCmn": (lambda T, d: T.SlidingWindowCmn(cmn_window=20), FEATS, F32, False),
    "SlidingWindowCmn centred, variance": (lambda T, d: T.SlidingWindowCmn(20, 10, center=True, norm_vars=True),
                                           FEATS, F32, False),
    "SpectralCentroid": (lambda T, d: T.SpectralCentroid(SR, n_fft=256, hop_length=128, **d), WAVE, F32, False),
    "PitchShift +12": (lambda T, d: T.PitchShift(SR, 12, n_fft=256, **d), WAVE, None, False),
    "Preemphasis": (lambda T, d: T.Preemphasis(), WAVE, dict(atol=1e-7, rtol=0), False),
    "Deemphasis 0.9": (lambda T, d: T.Deemphasis(0.9), WAVE, F32, False),
}


def _pitch_tol(make, x):
    """The float32 phase-accumulation bound of the pitch_shift parity test: the JAX package takes the
    phase advance in float64 (x64 on), the port in float32; 4 eps_f32 frames (pi hop + 2 pi) max|x|."""
    hop = make(TT, CPU).hop_length
    frames = x.shape[-1] * 2 // hop + 2
    return dict(atol=4 * np.finfo(np.float32).eps * frames * (math.pi * hop + 2 * math.pi) * np.abs(x).max(), rtol=0)


# under jit XLA fuses preemphasis's product and difference into one rounding, a float32 ulp from the
# eager result that the JAX package's test holds to 1e-7
EAGER = {"Preemphasis"}


@functools.lru_cache(maxsize=None)
def _jax_cases() -> dict:
    """Every JIT case through its JAX class, all in one ``jax.jit`` (one compile for the table)."""
    names = [n for n in CASES if n not in EAGER]
    outs = _jit(lambda *xs: [CASES[n][0](JT, {})(x) for n, x in zip(names, xs)], *(CASES[n][1] for n in names))
    return {n: np.asarray(o) for n, o in zip(names, outs)}


@pytest.mark.parametrize("name", list(CASES))
def test_transform_matches_jax(name):
    make, x, tol, relative = CASES[name]
    t = make(TT, CPU)
    ref = np.asarray(make(JT, {})(jnp.asarray(x))) if name in EAGER else _jax_cases()[name]
    got = t(_t(x))
    assert tuple(got.shape) == ref.shape
    assert got.dtype == (torch.complex64 if got.is_complex() else torch.float32)  # the input's (or mu-law's)
    tol = tol or _pitch_tol(make, x)
    if relative:
        _peak_close(got, ref, tol)
    else:
        np.testing.assert_allclose(got.numpy(), ref, **tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_mu_law_encoding_codes_equal(dtype):
    x = np.concatenate([_wave((1, 4000), seed=4).clip(-1, 1), np.linspace(-1, 1, 513)[None]], axis=1).astype(dtype)
    j, t = _both(lambda T, d: T.MuLawEncoding(256))
    got = t(_t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jit(j, x)))


@pytest.mark.parametrize("shape", ["linear", "exponential", "logarithmic", "quarter_sine", "half_sine"])
def test_fade_matches_jax(shape):
    for fin, fout in ((200, 300), (0, 2000), (1, 0)):
        j, t = _both(lambda T, d: T.Fade(fin, fout, shape))
        np.testing.assert_allclose(t(_t(WAVE)).numpy(), np.asarray(_jit(j, WAVE)), **F32)
    with pytest.raises(ValueError, match="Unknown fade_shape"):
        TT.Fade(10, 10, "cubic")(_t(WAVE))


def test_inverse_spectrogram_and_griffinlim_match_jax(monkeypatch):
    """The inverse of a complex spectrogram (with and without ``length``); Griffin-Lim without random
    phases, and with them on the port generator's draws (real then imaginary parts)."""
    spec = np.asarray(_jit(JT.Spectrogram(n_fft=256, hop_length=128, power=None), WAVE))
    j, t = _both(lambda T, d: T.InverseSpectrogram(n_fft=256, hop_length=128, **d))
    for length in (2000, None):
        _peak_close(t(_t(spec), length), _jit(lambda s: j(s, length), spec))
    power = np.abs(spec).astype(np.float32) ** 2
    j, t = _both(lambda T, d: T.GriffinLim(n_fft=256, hop_length=128, n_iter=8, length=2000, rand_init=False, **d))
    _peak_close(t(_t(power)), _jit(j, power))
    j, t = _both(lambda T, d: T.GriffinLim(n_fft=256, hop_length=128, n_iter=4, length=2000, **d))
    got = t(_t(power), torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    queue = [jnp.asarray(torch.rand(power.shape, generator=g).numpy()) for _ in range(2)]
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), dtype=None, *a, **k: queue.pop(0))
    ref = _jit(lambda p: j(p, jax.random.PRNGKey(0)), power)
    assert not queue
    _peak_close(got, ref)
    assert torch.equal(t(_t(power)), t(_t(power), torch.Generator().manual_seed(0)))


def test_inverse_mel_scale_matches_jax_and_refuses_a_rank_deficient_bank_with_gels():
    mel = np.asarray(_jit(JT.MelScale(n_mels=40, sample_rate=SR, n_stft=201), np.abs(_wave((2, 201, 12), seed=5))))
    for driver in ("gels", "gelsd"):
        j, t = _both(lambda T, d: T.InverseMelScale(201, 40, driver=driver, **d))
        np.testing.assert_allclose(t.fb_pinv.numpy(), np.asarray(j.fb_pinv), atol=1e-5, rtol=1e-4)
        _peak_close(t(_t(mel)), _jit(j, mel))
        assert t(_t(mel).to(torch.bfloat16)).dtype == torch.float32  # the float32 bank promotes, as in JAX
    with pytest.raises(RuntimeError, match="full rank"):
        TT.InverseMelScale(n_stft=201, n_mels=64, sample_rate=SR, driver="gels", device="cpu")
    # a rank-deficient bank: the two SVDs' smallest singular values differ, and so does the part of the
    # solution along them; what the bank sees of it (its mel spectrogram) agrees, within the JAX
    # package's own test's 5% of the input mel
    j, t = _both(lambda T, d: T.InverseMelScale(n_stft=201, n_mels=64, sample_rate=SR, driver="gelsy", **d))
    mel_t = TT.MelScale(n_mels=64, sample_rate=SR, n_stft=201, device="cpu")
    mel64 = mel_t(_t(np.abs(_wave((201, 12)))))
    rec, ref = t(mel64), _jit(j, mel64.numpy())
    _peak_close(mel_t(rec), mel_t(_t(ref)))
    assert float(torch.linalg.norm(mel_t(rec) - mel64) / torch.linalg.norm(mel64)) < 0.05
    for bad in (dict(driver="qr"), dict(f_min=9000.0)):
        with pytest.raises(ValueError):
            TT.InverseMelScale(201, 40, device="cpu", **bad)
    with pytest.raises(ValueError, match="mel bins"):
        TT.InverseMelScale(201, 40, device="cpu")(torch.zeros(2, 39, 5))


@pytest.mark.parametrize("rate", [1.1, 0.8])
def test_time_stretch_matches_jax(rate):
    """float32 ``phase_advance`` (torchaudio's) against the JAX package's float64 one (x64 on): the
    port accumulates the phase in float32, whose rounding, up to pi hop + 2 pi a frame, bounds the
    difference: 4 eps_f32 frames (pi hop + 2 pi) of the peak, the pitch_shift parity test's bound."""
    spec = np.asarray(_jit(JT.Spectrogram(n_fft=256, hop_length=128, power=None), WAVE))
    j, t = _both(lambda T, d: T.TimeStretch(hop_length=128, n_freq=129, fixed_rate=1.1, **d))
    assert t.phase_advance.dtype == torch.float32
    got = t(_t(spec), None if rate == 1.1 else rate)
    ref = _jit(lambda s: j(s, None if rate == 1.1 else rate), spec)
    bound = 4 * np.finfo(np.float32).eps * got.shape[-1] * (math.pi * 128 + 2 * math.pi)
    _peak_close(got, ref, dict(atol=bound, rtol=0))
    assert got.dtype == torch.complex64 and got.shape[-1] == math.ceil(spec.shape[-1] / rate)
    with pytest.raises(ValueError, match="fixed_rate"):
        TT.TimeStretch(n_freq=129, device="cpu")(_t(spec))


def test_vad_trims_as_jax():
    """Noise, a voiced tone, noise at 8 kHz (the functional parity test's recording): the same slice."""
    sr = 8000
    voiced = 0.3 * sum(np.sin(2 * np.pi * 150 * h * np.arange(sr) / sr) / h for h in range(1, 12))
    sig = np.concatenate([0.005 * np.random.default_rng(6).standard_normal(sr), voiced,
                          0.005 * np.random.default_rng(7).standard_normal(sr // 2)]).astype(np.float32)
    j, t = _both(lambda T, d: T.Vad(sr, trigger_time=0.2))
    ref = np.asarray(j(jnp.asarray(sig)))
    got = t(_t(sig))
    assert 0 < got.shape[-1] < sig.shape[-1]
    np.testing.assert_array_equal(got.numpy(), ref)


# --------------------------------------------------------------------------- two inputs, lengths, losses

@pytest.mark.parametrize("mode", ["full", "valid", "same"])
def test_convolutions_match_jax(mode):
    k = _wave((2, 31), seed=7)
    for name in ("Convolve", "FFTConvolve"):
        j, t = _both(lambda T, d: getattr(T, name)(mode))
        np.testing.assert_allclose(t(_t(WAVE), _t(k)).numpy(), np.asarray(_jit(j, WAVE, k)),
                                   **F32)


def test_add_noise_matches_jax():
    noise, snr = _wave(seed=8), np.array([5.0, 10.0], np.float32)
    j, t = _both(lambda T, d: T.AddNoise())
    for lengths in (None, np.array([1500, 2000])):
        ref = _jit(j, WAVE, noise, snr) if lengths is None else _jit(j, WAVE, noise, snr, lengths)
        got = t(_t(WAVE), _t(noise), _t(snr), None if lengths is None else _t(lengths))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("factor", [1.1, 0.9])
def test_speed_matches_jax_and_its_lengths_are_equal(factor):
    j, t = _both(lambda T, d: T.Speed(SR, factor, **d))
    for lengths in (np.array([2000, 1371]), np.array([2000.0, 1371.0], np.float32), None):
        y_ref, l_ref = _jit(j, WAVE) if lengths is None else _jit(j, WAVE, lengths)
        y, l_got = t(_t(WAVE), None if lengths is None else _t(lengths))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **F32)
        if lengths is None:
            assert l_got is None and l_ref is None
        else:
            assert l_got.dtype == _t(lengths).dtype
            np.testing.assert_array_equal(l_got.numpy(), np.asarray(l_ref))


def test_speed_perturbation_matches_jax_on_the_same_draw(monkeypatch):
    """The speeder is chosen by one draw of ``randint`` from the generator; the JAX class is given the
    same index.  ``None`` stands for a generator seeded 0."""
    factors = [0.9, 1.0, 1.1]
    j, t = _both(lambda T, d: T.SpeedPerturbation(SR, factors, **d))
    lengths = np.array([2000, 1800])
    seeds = {int(torch.randint(0, 3, (), generator=torch.Generator().manual_seed(s))): s for s in range(20)}
    assert sorted(seeds) == [0, 1, 2]
    for idx, seed in seeds.items():
        monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi, *a, **k: np.int64(idx))
        y_ref, l_ref = _jit(j, WAVE, lengths)
        y, l_got = t(_t(WAVE), _t(lengths), torch.Generator().manual_seed(seed))
        assert y.shape[-1] == y_ref.shape[-1] == t.speeders[idx].resampler(_t(WAVE)).shape[-1]
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **F32)
        np.testing.assert_array_equal(l_got.numpy(), np.asarray(l_ref))
    assert torch.equal(t(_t(WAVE))[0], t(_t(WAVE), generator=torch.Generator().manual_seed(0))[0])


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_rnnt_loss_matches_jax(reduction):
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 6, 4, 5)).astype(np.float32)
    tgt = rng.integers(1, 5, (2, 3)).astype(np.int32)
    lg, tg = np.array([6, 5], np.int32), np.array([3, 2], np.int32)
    j, t = _both(lambda T, d: T.RNNTLoss(blank=0, reduction=reduction))
    ref = _jit(j, logits, tgt, lg, tg)
    got = t(_t(logits), _t(tgt), _t(lg), _t(tg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


# --------------------------------------------------------------------------- masks on the port's draws

def _jax_on_torch_draws(monkeypatch, draws):
    """Replace jax.random.uniform by the port's draws, in the order the JAX class asks."""
    queue = [jnp.asarray(d.numpy()) for d in draws]
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: queue.pop(0))
    return queue


def _draws(seed: int, shapes) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(s, generator=g) for s in shapes for _ in range(2)]


@pytest.mark.parametrize("cls,param,iid,shape,draw", [
    ("FrequencyMasking", 15, False, (2, 40, 50), ()),
    ("TimeMasking", 20, False, (2, 40, 50), ()),
    ("FrequencyMasking", 15, True, (3, 2, 40, 50), (3, 2)),
    ("TimeMasking", 20, True, (3, 2, 40, 50), (3, 2)),
])
def test_axis_masking_matches_jax_on_the_same_draws(monkeypatch, cls, param, iid, shape, draw):
    x = _wave(shape, seed=10)
    j, t = _both(lambda T, d: getattr(T, cls)(param, iid_masks=iid))
    got = t(_t(x), -1.0, torch.Generator().manual_seed(11))
    queue = _jax_on_torch_draws(monkeypatch, _draws(11, [draw]))
    ref = np.asarray(_jit(lambda v: j(v, -1.0, key=jax.random.PRNGKey(0)), x))
    assert not queue
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < int((got == -1.0).sum())


@pytest.mark.parametrize("iid,shape,zero", [(True, (3, 2, 40, 50), False), (True, (2, 40, 50), True),
                                            (False, (2, 40, 50), False), (True, (40, 50), False)])
def test_spec_augment_matches_jax_on_the_same_draws(monkeypatch, iid, shape, zero):
    """Two time masks, then two frequency masks, from one generator in that order; the fill is the
    spectrogram's mean unless zero_masking; iid masks only on 3D and up."""
    x = _wave(shape, seed=12)
    j, t = _both(lambda T, d: T.SpecAugment(2, 15, 2, 10, iid_masks=iid, zero_masking=zero))
    got = t(_t(x), torch.Generator().manual_seed(13))
    lead = shape[:-2] if iid and len(shape) > 2 else ()
    queue = _jax_on_torch_draws(monkeypatch, _draws(13, [lead] * 4))
    ref = np.asarray(_jit(lambda v: j(v, jax.random.PRNGKey(0)), x))
    assert not queue
    fill = 0.0 if zero else float(_t(x).mean())
    masked = got.numpy() == np.float32(fill)
    assert masked.any()
    np.testing.assert_array_equal(masked, ref == (0.0 if zero else ref[masked][0]))  # the same spans
    np.testing.assert_allclose(got.numpy(), ref, **F32)  # the two means differ in their last bits
    assert torch.equal(t(_t(x)), t(_t(x), torch.Generator().manual_seed(0)))


# --------------------------------------------------------------------------- multi-channel

def _stft(seed: int, shape=(2, 4, 9, 30)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b, c, f, n = shape
    src = rng.standard_normal((b, 1, f, n)) + 1j * rng.standard_normal((b, 1, f, n))
    h = rng.standard_normal((b, c, f, 1)) + 1j * rng.standard_normal((b, c, f, 1))
    return (src * h + 0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)


MASK = np.random.default_rng(14).uniform(0.05, 0.95, (3, 2, 9, 30)).astype(np.float32)  # three calls' masks


@pytest.mark.parametrize("multi_mask", [False, True])
def test_psd_matches_jax(multi_mask):
    spec = _stft(15)
    mask = np.broadcast_to(MASK[0][:, None], (2, 4, 9, 30)).copy() if multi_mask else MASK[0]
    j, t = _both(lambda T, d: T.PSD(multi_mask=multi_mask))
    for m in (mask, None):
        _peak_close(t(_t(spec), None if m is None else _t(m)),
                    _jit(j, spec) if m is None else _jit(j, spec, m))


@pytest.mark.parametrize("solution", ["ref_channel", "stv_evd", "stv_power"])
def test_mvdr_matches_jax(solution):
    """The weights built from an eigenvector with a reference channel do not depend on the
    eigensolver's unit factor, so ``stv_evd`` compares directly."""
    spec = _stft(16)
    j, t = _both(lambda T, d: T.MVDR(ref_channel=1, solution=solution))
    out = t(_t(spec), _t(MASK[0]), _t(1 - MASK[0]))
    assert out.dtype == torch.complex64
    _peak_close(out, _jit(j, spec, MASK[0], 1 - MASK[0]))


def test_online_mvdr_matches_jax_over_three_calls():
    """Both objects carry their PSDs and mask sums (of the channels' mean masks) from one call to the
    next.  The JAX object's call
    runs under ``jax.jit`` with its state passed in and handed back out, so that no traced value
    stays on the object."""
    state = ("psd_s", "psd_n", "mask_sum_s", "mask_sum_n")
    specs = [_stft(16 + i) for i in range(3)]
    masks = [np.broadcast_to(m[:, None], (2, 4, 9, 30)).copy() for m in MASK]  # one mask a channel
    j, t = _both(lambda T, d: T.MVDR(ref_channel=0, solution="stv_power", multi_mask=True, online=True))

    def jax_call(spec, mask, *carried):
        for name, value in zip(state, carried):
            setattr(j, name, value)
        out = j(spec, mask, 1 - mask)
        return out, tuple(getattr(j, name) for name in state)

    for spec, mask in zip(specs, masks):
        carried = () if j.psd_s is None else tuple(getattr(j, name) for name in state)
        ref, carried = _jit(jax_call, spec, mask, *carried)
        for name, value in zip(state, carried):
            setattr(j, name, value)
        _peak_close(t(_t(spec), _t(mask), _t(1 - mask)), ref)
        _peak_close(t.psd_s, j.psd_s)
        np.testing.assert_allclose(t.mask_sum_n.numpy(), np.asarray(j.mask_sum_n), **F32)


def test_mvdr_multi_mask_warns_without_mask_n_and_checks_its_input():
    spec = _stft(19)
    mask = np.broadcast_to(MASK[1][:, None], (2, 4, 9, 30)).copy()
    j, t = _both(lambda T, d: T.MVDR(multi_mask=True))
    with pytest.warns(UserWarning, match="mask_n"):
        got = t(_t(spec), _t(mask))
    with pytest.warns(UserWarning, match="mask_n"):
        ref = _jit(j, spec, mask)
    _peak_close(got, ref)
    with pytest.raises(ValueError, match="complex"):
        t(_t(spec.real.copy()), _t(mask))
    with pytest.raises(ValueError, match="3D"):
        t(_t(spec[0, 0]), _t(mask))
    with pytest.raises(ValueError, match="solution"):
        TT.MVDR(solution="svd")


def test_rtf_and_souden_mvdr_match_jax():
    import audio_tpu.functional as JF

    spec = _stft(20)
    psd_s, psd_n = (np.asarray(_jit(JF.psd, spec, m)) for m in (MASK[2], 1 - MASK[2]))
    rtf = np.asarray(_jit(lambda s, n: JF.rtf_power(s, n, 0), psd_s, psd_n))
    onehot = np.eye(4, dtype=np.float32)[2]  # a reference vector, where RTFMVDR takes channel 0
    j, t = _both(lambda T, d: T.RTFMVDR())
    _peak_close(t(_t(spec), _t(rtf), _t(psd_n), 0), _jit(lambda *a: j(*a, 0), spec, rtf, psd_n))
    j, t = _both(lambda T, d: T.SoudenMVDR())
    _peak_close(t(_t(spec), _t(psd_s), _t(psd_n), _t(onehot), False),
                _jit(lambda *a: j(*a, False), spec, psd_s, psd_n, onehot))


# --------------------------------------------------------------------------- the contract of the classes

def _params(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


def _port_default(value):
    """The JAX default as the port spells it: float32 in torch's name, a window function by its name."""
    if value is jnp.float32:
        return torch.float32
    return value.__name__ if callable(value) else value


@pytest.mark.parametrize("name", JT.__all__)
def test_class_keeps_the_jax_signature_with_a_device_and_a_generator(name):
    """The same constructor and forward parameters, defaults and order as the JAX class.  A class that
    makes buffers takes ``device`` last, CUDA by default; a ``key`` becomes a ``generator``."""
    j, t = getattr(JT, name), getattr(TT, name)
    assert issubclass(t, torch.nn.Module)
    want = [(n, _port_default(d)) for n, d in _params(j.__init__)]
    got = [(n, d.__name__ if callable(d) else d) for n, d in _params(t.__init__)]
    if got and got[-1][0] == "device":
        assert got[-1][1] == "cuda"
        got = got[:-1]
    assert got == want
    want_fwd = [("generator" if n == "key" else n, d) for n, d in _params(j.forward)]
    assert _params(t.forward) == want_fwd


BUFFERED = ["Spectrogram", "InverseSpectrogram", "GriffinLim", "MelScale", "InverseMelScale", "MelSpectrogram",
            "MFCC", "LFCC", "Resample", "TimeStretch", "SpectralCentroid", "PitchShift", "Speed",
            "SpeedPerturbation"]


@pytest.mark.parametrize("name", BUFFERED)
def test_buffers_are_non_persistent_and_made_on_the_given_device(name):
    """Each buffer-making class defaults to CUDA; on ``device="cpu"`` its buffers lie there, follow
    ``.to``, and stay out of the state dict."""
    make = {"InverseMelScale": lambda d: TT.InverseMelScale(201, 40, **d),
            "Resample": lambda d: TT.Resample(SR, 8000, **d),
            "PitchShift": lambda d: TT.PitchShift(SR, 2, **d),
            "SpectralCentroid": lambda d: TT.SpectralCentroid(SR, **d),
            "Speed": lambda d: TT.Speed(SR, 1.1, **d),
            "SpeedPerturbation": lambda d: TT.SpeedPerturbation(SR, [0.9, 1.1], **d)}.get(
        name, lambda d: getattr(TT, name)(**d))
    m = make(CPU)
    buffers = dict(m.named_buffers())
    assert buffers and all(b.device.type == "cpu" for b in buffers.values())
    assert not m.state_dict()
    assert all(b.dtype == torch.float64 for b in m.to(torch.float64).buffers())


def test_spectrogram_warns_on_return_complex():
    with pytest.warns(UserWarning, match="return_complex"):
        TT.Spectrogram(return_complex=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TT.Spectrogram(device="cpu")


# --------------------------------------------------------------------------- half precision

HALF_TOL = {torch.bfloat16: 4e-2, torch.float16: 5e-3}
HALF_CASES = {  # the JAX dtype matrix's rows: factory, input shape, tolerance multiple
    "Spectrogram": (lambda: TT.Spectrogram(n_fft=256, hop_length=128, device="cpu"), (2, 2000), 1.0),
    "MelSpectrogram": (lambda: TT.MelSpectrogram(sample_rate=SR, n_fft=256, hop_length=128, n_mels=23, device="cpu"),
                       (2, 2000), 1.0),
    "MFCC": (lambda: TT.MFCC(sample_rate=SR, n_mfcc=13, melkwargs={"n_fft": 256, "hop_length": 128, "n_mels": 23},
                             device="cpu"), (2, 2000), 2.0),
    "LFCC": (lambda: TT.LFCC(sample_rate=SR, n_lfcc=13, speckwargs={"n_fft": 256, "hop_length": 128}, device="cpu"),
             (2, 2000), 2.0),
    "Resample": (lambda: TT.Resample(SR, 8000, device="cpu"), (2, 2000), 1.0),
    "MelScale": (lambda: TT.MelScale(n_mels=23, sample_rate=SR, n_stft=129, device="cpu"), (2, 129, 10), 1.0),
    "AmplitudeToDB": (lambda: TT.AmplitudeToDB("power", 80.0), (2, 200), 1.0),
    "ComputeDeltas": (lambda: TT.ComputeDeltas(), (2, 40, 50), 1.0),
    "Fade": (lambda: TT.Fade(fade_in_len=200, fade_out_len=200), (2, 2000), 1.0),
    "Vol": (lambda: TT.Vol(2.0), (2, 2000), 1.0),
    "Preemphasis": (lambda: TT.Preemphasis(), (2, 2000), 1.0),
    "Deemphasis": (lambda: TT.Deemphasis(), (2, 2000), 8.0),
    "SlidingWindowCmn": (lambda: TT.SlidingWindowCmn(cmn_window=20), (2, 50, 40), 2.0),
    "SpectralCentroid": (lambda: TT.SpectralCentroid(SR, n_fft=256, hop_length=128, device="cpu"), (2, 2000), 8.0),
    "Speed": (lambda: (lambda x, s=TT.Speed(SR, 1.1, device="cpu"): s(x)[0]), (2, 2000), 2.0),
    "Loudness": (lambda: TT.Loudness(SR), (2, 8000), 1.0),
    "PitchShift": (lambda: TT.PitchShift(SR, 12, n_fft=256, device="cpu"), (2, 2000), 2.0),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("name", list(HALF_CASES))
def test_half_precision_follows_the_input_dtype(name, dtype):
    """The JAX dtype matrix's contract: the output's dtype is the input's, finite, within the dtype's
    tolerance (times the row's multiple) of the float32 result, relative to its peak."""
    make, shape, mult = HALF_CASES[name]
    tr = make()
    x = _t(np.abs(_wave(shape)) if name in ("MelScale", "AmplitudeToDB") else _wave(shape))
    lo, hi = tr(x.to(dtype)), tr(x)
    assert lo.dtype == dtype
    lo, hi = lo.float(), hi.float()
    assert bool(torch.isfinite(lo).all())
    scale = float(hi.abs().max()) + 1e-6
    np.testing.assert_allclose((lo / scale).numpy(), (hi / scale).numpy(), atol=HALF_TOL[dtype] * mult)


def test_masks_keep_half_precision_and_their_spans():
    x = _t(_wave((2, 40, 50), seed=1))
    for tr in (TT.FrequencyMasking(10), TT.TimeMasking(10), TT.SpecAugment(2, 10, 2, 10, zero_masking=True)):
        lo = tr(x.half(), generator=torch.Generator().manual_seed(3))
        hi = tr(x, generator=torch.Generator().manual_seed(3))
        assert lo.dtype == torch.float16
        assert torch.equal(lo.float() == 0.0, hi == 0.0)
