"""The port's sox effects (CPU) against the JAX package.

The same seeded numpy inputs go through ``audio_tpu.functional`` and
``audio_tpu_torch.functional``.  In float64 every effect agrees to 1e-9 abs
(the two compute the same operations in the same order).  In float32 the
tolerances are the JAX package's own tests' (tests/functional/test_filtering.py):
contrast 1e-5 abs, dcshift 1e-6 abs, gain 1e-6 rel, and for the recurrences
(overdrive, and phaser and flanger, which that file only runs) overdrive's
1e-5 abs + 1e-4 rel.  ``dither``'s RPDF and GPDF draws come from a
``torch.Generator`` where the JAX package takes a key: they are held to the
formula with the generator's own draw, and the draws to their distribution.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audio_tpu.functional as JF

import audio_tpu_torch.functional as TF
from audio_tpu_torch.functional import _filtering as tf_filtering

from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

SR = 16000
F64 = dict(atol=1e-9, rtol=0)
RECURRENCE_F32 = dict(atol=1e-5, rtol=1e-4)
DTYPES = [np.float64, np.float32]


def _ids(dt):
    return np.dtype(dt).name


def _noise(seed: int, shape, dtype, scale: float = 0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(dtype)


def _both(fn_j, fn_t, x: np.ndarray):
    ref = np.asarray(fn_j(jnp.asarray(x)))
    got = fn_t(torch.from_numpy(x.copy()))
    assert got.dtype == torch.from_numpy(x).dtype and tuple(got.shape) == x.shape
    return got.numpy(), ref


ELEMENTWISE = {
    "contrast_75": (lambda f: lambda w: f.contrast(w, 75.0), dict(atol=1e-5, rtol=0)),
    "contrast_0": (lambda f: lambda w: f.contrast(w, 0.0), dict(atol=1e-5, rtol=0)),
    "contrast_100": (lambda f: lambda w: f.contrast(w, 100.0), dict(atol=1e-5, rtol=0)),
    "dcshift_no_limiter": (lambda f: lambda w: f.dcshift(w, 0.2), dict(atol=1e-6, rtol=0)),
    "dcshift_limiter_positive": (lambda f: lambda w: f.dcshift(w, 0.2, 0.05), dict(atol=1e-6, rtol=0)),
    "dcshift_limiter_negative": (lambda f: lambda w: f.dcshift(w, -0.3, 0.05), dict(atol=1e-6, rtol=0)),
    "gain_6": (lambda f: lambda w: f.gain(w, 6.0), dict(atol=0, rtol=1e-6)),
    "gain_0": (lambda f: lambda w: f.gain(w, 0.0), dict(atol=0, rtol=1e-6)),
    "gain_-3": (lambda f: lambda w: f.gain(w, -3.0), dict(atol=0, rtol=1e-6)),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("name", list(ELEMENTWISE))
def test_elementwise_effects_match_jax(name, dtype):
    make, tol32 = ELEMENTWISE[name]
    x = _noise(1, (2, 3, 700), dtype, scale=0.6)  # past the limiters' thresholds
    got, ref = _both(make(JF), make(TF), x)
    np.testing.assert_allclose(got, ref, **(F64 if dtype == np.float64 else tol32))


def test_dcshift_limiters_take_both_branches():
    """Each limiter sign has samples on its peaked branch and on its clipped one."""
    x = torch.from_numpy(_noise(1, (2, 3, 700), np.float64, scale=0.6))
    for shift, peaked in ((0.2, x > 1.0 - (0.2 - 0.05)), (-0.3, x < -(1.0 - (0.3 - 0.05)))):
        y = TF.dcshift(x, shift, 0.05)
        assert bool(peaked.any()) and bool((~peaked).any())
        assert not torch.equal(y[peaked], torch.clamp(x[peaked] + shift, -1, 1))


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("shape", [(3, 400), (2, 3, 300)], ids=["2d", "3d"])
def test_overdrive_matches_jax(shape, dtype):
    x = _noise(2, shape, dtype, scale=0.5)
    got, ref = _both(lambda w: JF.overdrive(w, 20.0, 20.0), lambda w: TF.overdrive(w, 20.0, 20.0), x)
    np.testing.assert_allclose(got, ref, **(F64 if dtype == np.float64 else RECURRENCE_F32))


def test_overdrive_matches_the_sox_loop():
    """The JAX package's oracle: the stateful loop of overdrive.cpp."""
    x = _noise(3, (2, 320), np.float32, scale=0.5)
    got = TF.overdrive(torch.from_numpy(x), 20.0, 20.0).numpy()
    g, colour = math.exp(20.0 * math.log(10) / 20.0), 20.0 / 200
    temp = x * g + colour
    temp = np.where(temp < -1, -2 / 3, np.where(temp > 1, 2 / 3, temp - temp**3 / 3))
    out, last_in, last_out = np.zeros_like(x), np.zeros(x.shape[0]), np.zeros(x.shape[0])
    for i in range(x.shape[-1]):
        last_out = temp[:, i] - last_in + 0.995 * last_out
        last_in = temp[:, i]
        out[:, i] = x[:, i] * 0.5 + last_out * 0.75
    np.testing.assert_allclose(got, np.clip(out, -1, 1), **RECURRENCE_F32)


def test_overdrive_takes_the_plain_recurrence_on_cuda_outside_float32():
    """K4 takes only float32: on the card another dtype runs the plain recurrence there, by the
    dtype alone, as lfilter's route rule gives it."""
    assert tf_filtering._filter_route(True, torch.float64, 16000, 2) == "plain"
    assert tf_filtering._filter_route(True, torch.float16, 16000, 2) == "plain"
    assert tf_filtering._filter_route(True, torch.float32, 16000, 2) != "plain"
    assert tf_filtering._filter_route(False, torch.float64, 16000, 2) != "plain"


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("sinusoidal", [True, False], ids=["sine", "triangle"])
def test_phaser_matches_jax(sinusoidal, dtype):
    x = _noise(4, (2, 2, 600), dtype)
    kw = dict(gain_in=0.5, gain_out=0.8, delay_ms=2.0, decay=0.4, mod_speed=2.0, sinusoidal=sinusoidal)
    got, ref = _both(lambda w: JF.phaser(w, 8000, **kw), lambda w: TF.phaser(w, 8000, **kw), x)
    np.testing.assert_allclose(got, ref, **(F64 if dtype == np.float64 else RECURRENCE_F32))


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("regen", [0.0, 50.0], ids=["regen0", "regen50"])
@pytest.mark.parametrize("interpolation", ["linear", "quadratic"])
@pytest.mark.parametrize("channels,modulation", [(1, "sinusoidal"), (4, "triangular")], ids=["1ch", "4ch"])
def test_flanger_matches_jax(channels, modulation, interpolation, regen, dtype):
    x = _noise(5, (2, channels, 500), dtype)
    kw = dict(delay=1.0, depth=2.0, regen=regen, width=71.0, speed=2.0, phase=25.0, modulation=modulation,
              interpolation=interpolation)
    got, ref = _both(lambda w: JF.flanger(w, 8000, **kw), lambda w: TF.flanger(w, 8000, **kw), x)
    np.testing.assert_allclose(got, ref, **(F64 if dtype == np.float64 else RECURRENCE_F32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("interpolation", ["linear", "quadratic"])
@pytest.mark.parametrize("modulation", ["sinusoidal", "triangular"])
def test_flanger_without_feedback_is_the_loop_bit_for_bit(modulation, interpolation, dtype):
    """At regen 0 the public function gathers the input's past with no time loop; it gives the
    loop's bits.  A 1 ms delay and 2 ms depth at 16 kHz: lags of 16 to 48 samples, past the line's
    length once the tap is added, and steps before the first write (zeros)."""
    x = torch.from_numpy(_noise(6, (3, 4, 800), np.float64)).to(dtype)
    tab = tf_filtering._flanger_tables(4, 800, SR, 1.0, 2.0, 71.0, 5.0, 25.0, modulation, 0.0)
    quadratic = interpolation == "quadratic"
    loop = tf_filtering._flanger_loop(x, tab, quadratic)
    gathered = tf_filtering._flanger_gather(x, tab, quadratic)
    assert torch.equal(loop, gathered)
    out = TF.flanger(x, SR, delay=1.0, depth=2.0, speed=5.0, modulation=modulation, interpolation=interpolation)
    assert torch.equal(out, torch.clamp(x * tab["in_gain"] + loop * tab["delay_gain"], -1, 1))


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("noise_shaping", [False, True], ids=["plain", "shaped"])
def test_dither_tpdf_matches_jax(noise_shaping, dtype):
    x = _noise(7, (2, 3, 400), dtype)
    got, ref = _both(lambda w: JF.dither(w, "TPDF", noise_shaping), lambda w: TF.dither(w, "TPDF", noise_shaping), x)
    np.testing.assert_array_equal(got, ref)
    if not noise_shaping:  # on the 16-bit grid; the shaped error moves it off
        q = got * 2**15
        np.testing.assert_allclose(q, np.round(q), atol=1e-4)


@pytest.mark.parametrize("noise_shaping", [False, True], ids=["plain", "shaped"])
@pytest.mark.parametrize("density", ["RPDF", "GPDF"])
def test_dither_random_densities_follow_the_formula(density, noise_shaping):
    """The output is round(x (2^15 - 2) + n) / 2^15 with n the generator's own draw (one uniform less
    0.5, or seven summed less 3.5), then the shaped error if asked; on the 2^-15 grid."""
    x = torch.from_numpy(_noise(8, (3, 500), np.float32))
    got = TF.dither(x, density, noise_shaping, generator=torch.Generator().manual_seed(11))
    u = torch.rand((1 if density == "RPDF" else 7,), generator=torch.Generator().manual_seed(11))
    n = u[0] - 0.5 if density == "RPDF" else u.sum() - 3.5
    want = torch.round(x * (2**15 - 2) + n) / 2**15
    if noise_shaping:
        want = want + torch.nn.functional.pad(want - x, (1, 0))[..., :-1]
    assert got.dtype == x.dtype and torch.equal(got, want)
    if not noise_shaping:
        q = got.double() * 2**15
        assert torch.equal(q, torch.round(q))


def test_dither_without_a_generator_draws_from_seed_0():
    x = torch.from_numpy(_noise(9, (2, 300), np.float32))
    for density in ("RPDF", "GPDF"):
        assert torch.equal(TF.dither(x, density), TF.dither(x, density, generator=torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("density,low,high,var", [("RPDF", -0.5, 0.5, 1 / 12), ("GPDF", -3.5, 3.5, 7 / 12)])
def test_dither_draws_over_200_seeds(density, low, high, var):
    """The draw's range and mean over 200 seeds, in float32 and float64: within the density's
    support, a mean within four standard errors of 0, a variance within 30 % of the density's."""
    for dtype in (torch.float32, torch.float64):
        draws = torch.stack([tf_filtering._dither_noise(density, torch.Generator().manual_seed(s), dtype,
                                                        torch.device("cpu")) for s in range(200)]).double()
        assert float(draws.min()) >= low and float(draws.max()) < high
        assert abs(float(draws.mean())) < 4 * math.sqrt(var / 200)
        assert abs(float(draws.var()) / var - 1) < 0.3


def test_effects_raise_as_the_jax_package():
    x = torch.zeros(1, 5, 100)
    with pytest.raises(ValueError, match="enhancement_amount"):
        TF.contrast(x, 101.0)
    with pytest.raises(ValueError, match="enhancement_amount"):
        TF.contrast(x, -1.0)
    with pytest.raises(ValueError, match="Max 4 channels"):
        TF.flanger(x, SR)
    with pytest.raises(ValueError, match="modulation"):
        TF.flanger(x[:, :2], SR, modulation="square")
    with pytest.raises(ValueError, match="interpolation"):
        TF.flanger(x[:, :2], SR, interpolation="cubic")
    with pytest.raises(ValueError):
        tf_filtering._generate_wave_table("SQUARE", "INT", 10, 0.0, 1.0, 0.0)


@pytest.mark.parametrize("wave_type,data_type", [("SINE", "INT"), ("TRIANGLE", "INT"), ("SINE", "FLOAT"),
                                                 ("TRIANGLE", "FLOAT")])
def test_wave_table_is_the_jax_package_s(wave_type, data_type):
    from audio_tpu.functional._filtering import _generate_wave_table

    for size, lo, hi, phase in ((32000, 1.0, 48.0, math.pi / 2), (777, 0.0, 34.0, 3 * math.pi / 2)):
        got = tf_filtering._generate_wave_table(wave_type, data_type, size, lo, hi, phase)
        ref = _generate_wave_table(wave_type, data_type, size, lo, hi, phase)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
