"""The port's Kaldi features (CPU) against ``audio_tpu.compliance.kaldi``.

The same seeded white noise (0.3 s at 16 kHz, as the JAX package's own test
uses) goes through both; JAX runs with x64 on (``tests/conftest.py``), each
table of calls under one ``jax.jit`` with the options closed over.  The tolerances are the
JAX package's test's (``tests/compliance/test_kaldi.py``): the spectrogram
2e-4 abs + 1e-4 rel, fbank and mfcc 3e-3 abs + 1e-4 rel, the mel banks
1e-5 abs + 1e-4 rel, the centre frequencies 1e-3, the VTLN warp 1e-6.
Dither draws from a ``torch.Generator`` where the JAX package takes a key:
the JAX function runs on the port's own draws (``jax.random.normal``
replaced by them).
"""

import functools
import math
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audio_tpu.compliance.kaldi as JK

import audio_tpu_torch.compliance.kaldi as TK

from .conftest import get_whitenoise
from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

WAV = get_whitenoise(duration=0.3, seed=11) * 0.5
WAV2 = np.concatenate([WAV, get_whitenoise(duration=0.3, seed=12) * 0.5])  # two channels
SPEC_TOL = dict(atol=2e-4, rtol=1e-4)
FEAT_TOL = dict(atol=3e-3, rtol=1e-4)


def _jax_calls(calls: dict, x=WAV) -> dict:
    """``{name: (function, kwargs)}`` through the JAX package, all in one ``jax.jit`` (one compile for
    a table of cases, which keeps the file's time down); the case "channel 1" reads WAV2.  ``mfcc``
    reads its DCT matrix back through numpy, which a traced value refuses: it is given the matrices
    ``create_dct`` makes, made before the trace."""
    sizes = {kw.get("num_mel_bins", 23) for _, kw in calls.values()}
    dcts = {n: np.asarray(JK.create_dct(n, n, "ortho")) for n in sizes}
    with mock.patch.object(JK, "create_dct", lambda n, m, norm: dcts[n]):
        out = jax.jit(lambda w, w2: {name: getattr(JK, fn)(w2 if name == "channel 1" else w, **kw)
                                     for name, (fn, kw) in calls.items()})(jnp.asarray(x), jnp.asarray(WAV2))
    return {name: np.asarray(v) for name, v in out.items()}


def _port(fn, x, **kw):
    return getattr(TK, fn)(torch.from_numpy(np.array(x)), **kw)


def _check(got: torch.Tensor, ref: np.ndarray, tol: dict) -> None:
    assert got.dtype == torch.from_numpy(np.array(ref)).dtype and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **tol)


SPECTROGRAM = {f"{w}{'' if snip else ', no snip_edges'}": {"snip_edges": snip, "window_type": w}
               for w in ("povey", "hanning", "hamming", "rectangular", "blackman") for snip in (True, False)}
SPECTROGRAM.update({
    "no pow2, mean": {"round_to_power_of_two": False, "subtract_mean": True},
    "energy after window, no dc or preemphasis": {"raw_energy": False, "energy_floor": 0.0,
                                                  "preemphasis_coefficient": 0.0, "remove_dc_offset": False},
    "8 kHz blackman": {"frame_length": 20.0, "frame_shift": 7.5, "sample_frequency": 8000.0, "blackman_coeff": 0.4,
                       "window_type": "blackman"},
})
FBANK = {
    "defaults": {},
    "40 bins 40-7600 Hz": {"num_mel_bins": 40, "low_freq": 40.0, "high_freq": 7600.0},
    "energy": {"use_energy": True},
    "energy htk": {"use_energy": True, "htk_compat": True},
    "magnitude, no log": {"use_power": False, "use_log_fbank": False},
    "no snip_edges": {"snip_edges": False},
    "vtln 1.1": {"vtln_warp": 1.1},
    "vtln 0.9, high -400": {"vtln_warp": 0.9, "vtln_high": -400.0, "vtln_low": 200.0},
    "energy after window, floor 0": {"raw_energy": False, "energy_floor": 0.0},
    "no preemphasis or dc": {"preemphasis_coefficient": 0.0, "remove_dc_offset": False},
    "no pow2": {"round_to_power_of_two": False},
    "subtract mean, hanning": {"subtract_mean": True, "window_type": "hanning"},
    "AST: htk, hanning, 128 bins": {"htk_compat": True, "window_type": "hanning", "num_mel_bins": 128,
                                    "frame_shift": 10.0, "use_energy": False, "dither": 0.0},
    "channel 1": {"channel": 1},
}
MFCC = {
    "defaults": {},
    "20 ceps of 40 bins": {"num_ceps": 20, "num_mel_bins": 40},
    "energy": {"use_energy": True},
    "energy htk": {"use_energy": True, "htk_compat": True},
    "htk": {"htk_compat": True},
    "no lifter": {"cepstral_lifter": 0.0},
    "vtln 1.1, subtract mean": {"vtln_warp": 1.1, "subtract_mean": True},
    "no snip_edges, hamming": {"snip_edges": False, "window_type": "hamming"},
}
TABLES = {"spectrogram": (SPECTROGRAM, SPEC_TOL), "fbank": (FBANK, FEAT_TOL), "mfcc": (MFCC, FEAT_TOL)}


@functools.lru_cache(maxsize=None)
def _jax_table(fn: str) -> dict:
    return _jax_calls({name: (fn, kw) for name, kw in TABLES[fn][0].items()})


@pytest.mark.parametrize("fn,case", [(fn, case) for fn, (cases, _) in TABLES.items() for case in cases])
def test_features_match_jax(fn, case):
    cases, tol = TABLES[fn]
    got = _port(fn, WAV2 if case == "channel 1" else WAV, **cases[case])
    _check(got, _jax_table(fn)[case], tol)
    if case == "channel 1":
        assert not torch.allclose(got, _port(fn, WAV2, channel=0))


DITHER_SEED = 21


@functools.lru_cache(maxsize=None)
def _jax_dithered() -> dict:
    """The three functions at dither 0.5 on the port generator's normal draws over the frames."""
    frames = TK._get_strided(torch.from_numpy(WAV[0]), 400, 160, True)
    draws = torch.randn(frames.shape, generator=torch.Generator().manual_seed(DITHER_SEED))
    with mock.patch.object(jax.random, "normal", lambda key, shape=(), dtype=None: draws.numpy()):
        return _jax_calls({fn: (fn, {"dither": 0.5}) for fn in TABLES})


@pytest.mark.parametrize("fn", list(TABLES))
def test_dither_matches_jax_on_the_same_draws(fn):
    """The noise is ``normal x dither`` over the frames, drawn from the generator (``None``: seeded 0);
    the JAX function is given the same normal draws."""
    got = _port(fn, WAV, dither=0.5, generator=torch.Generator().manual_seed(DITHER_SEED))
    _check(got, _jax_dithered()[fn], TABLES[fn][1])
    assert not np.allclose(got.numpy(), _port(fn, WAV).numpy(), **FEAT_TOL)  # the dither did something
    assert torch.equal(_port(fn, WAV, dither=0.5), _port(fn, WAV, dither=0.5,
                                                         generator=torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("fn", ["spectrogram", "fbank", "mfcc"])
def test_min_duration_and_bad_options(fn):
    """Shorter than ``min_duration``: an empty result from spectrogram and fbank, as in the JAX package.
    A channel past the input's, a window past it, a coefficient outside [0, 1] and a shift under a
    sample raise on both sides, a bad window type in the port."""
    if fn == "mfcc":  # the empty features meet the DCT matrix: both packages raise
        with pytest.raises(TypeError):
            JK.mfcc(jnp.asarray(WAV), min_duration=1.0)
        with pytest.raises(RuntimeError):
            TK.mfcc(torch.from_numpy(WAV), min_duration=1.0)
    else:
        ref = _jax_calls({fn: (fn, {"min_duration": 1.0})})[fn]
        assert tuple(_port(fn, WAV, min_duration=1.0).shape) == ref.shape == (0,)
    for bad in ({"channel": 1}, {"frame_length": 400.0}, {"preemphasis_coefficient": 1.5}, {"frame_shift": 0.01},
                {"window_type": "kaiser"}):
        if "window_type" not in bad:  # the JAX package raises these before it computes anything
            with pytest.raises(AssertionError):
                getattr(JK, fn)(jnp.asarray(WAV), **bad)
        with pytest.raises(ValueError):
            _port(fn, WAV, **bad)
    with pytest.raises(ValueError):
        TK.mfcc(torch.from_numpy(WAV), num_ceps=30) if fn == "mfcc" else TK.get_mel_banks(3, 512, 16000.0, 20.0, 0.0,
                                                                                          100.0, -500.0, 1.0)


@pytest.mark.parametrize("vtln", [1.0, 1.1, 0.85])
def test_mel_banks_match_jax(vtln):
    args = (23, 512, 16000.0, 20.0, 0.0, 100.0, -500.0, vtln)
    got, centers = TK.get_mel_banks(*args, device="cpu")
    ref, ref_centers = jax.jit(lambda: JK.get_mel_banks(*args))()
    assert got.dtype == centers.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(centers.numpy(), np.asarray(ref_centers), atol=1e-3)


def test_vtln_warp_and_mel_scales_match_jax():
    freqs, mels = np.linspace(0, 8000, 200), np.linspace(0, 2800, 50)
    ref = jax.jit(lambda f, m: (JK.vtln_warp_freq(100.0, 7500.0, 20.0, 7800.0, 1.1, f),
                                JK.vtln_warp_mel_freq(100.0, 7500.0, 20.0, 7800.0, 0.9, m),
                                JK.mel_scale(f), JK.inverse_mel_scale(m)))(jnp.asarray(freqs), jnp.asarray(mels))
    f, m = torch.from_numpy(freqs), torch.from_numpy(mels)
    np.testing.assert_allclose(TK.vtln_warp_freq(100.0, 7500.0, 20.0, 7800.0, 1.1, f).numpy(), ref[0], atol=1e-6)
    np.testing.assert_allclose(TK.vtln_warp_mel_freq(100.0, 7500.0, 20.0, 7800.0, 0.9, m).numpy(), ref[1], atol=1e-6)
    np.testing.assert_allclose(TK.mel_scale(f).numpy(), ref[2], rtol=1e-12)
    np.testing.assert_allclose(TK.inverse_mel_scale(m).numpy(), ref[3], rtol=1e-12)
    for f in (0.0, 440.0, 8000.0):
        assert TK.mel_scale_scalar(f) == JK.mel_scale_scalar(f)
        assert math.isclose(TK.inverse_mel_scale_scalar(TK.mel_scale_scalar(f)), f, abs_tol=1e-9)
        assert TK.inverse_mel_scale_scalar(f) == JK.inverse_mel_scale_scalar(f)
    with pytest.raises(ValueError, match="vtln_low"):
        TK.vtln_warp_freq(10.0, 7500.0, 20.0, 7800.0, 1.1, torch.from_numpy(freqs))


def test_float64_waveform_stays_float64():
    """A float64 waveform computes in float64 (the windows, banks and lifter cast to it), as the JAX
    package does with x64 on; both agree far inside the float32 tolerances."""
    x = WAV.astype(np.float64)
    kw = {"spectrogram": {}, "fbank": {"use_energy": True}, "mfcc": {"use_energy": True}}
    refs = _jax_calls({fn: (fn, kw[fn]) for fn in kw}, x)
    for fn in kw:
        got = _port(fn, x, **kw[fn])
        assert got.dtype == torch.float64
        _check(got, refs[fn], dict(atol=1e-8, rtol=1e-9))


def test_exports_and_frames():
    """The frames of 0..9: snipped, and mirrored at both ends (Kaldi's edges, the JAX package's
    ``_get_strided``), with the window's half past the shift's half (pad 2 - 1) and short of it."""
    assert set(TK.__all__) == set(JK.__all__) and len(TK.__all__) == 10
    x = torch.arange(10.0)
    assert TK._get_strided(x, 4, 2, True).tolist() == [[0, 1, 2, 3], [2, 3, 4, 5], [4, 5, 6, 7], [6, 7, 8, 9]]
    assert TK._get_strided(x, 5, 2, False).tolist() == [[0, 0, 1, 2, 3], [1, 2, 3, 4, 5], [3, 4, 5, 6, 7],
                                                        [5, 6, 7, 8, 9], [7, 8, 9, 9, 8]]
    assert TK._get_strided(x, 4, 6, False).tolist() == [[1, 2, 3, 4], [7, 8, 9, 9]]
    assert TK._get_strided(x, 11, 2, True).shape == (0, 11)
