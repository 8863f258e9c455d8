"""The port's spectral ops (CPU, plain versions) against the JAX package.

Inputs are float32 numpy arrays from a seed, fed to both sides; JAX outputs
are cast to float32 (tests/conftest.py turns on x64).  Spectrogram values are
compared to 5e-4 of their peak, the JAX package's spectrogram tolerance
(tests/ops/test_pallas_spectrogram.py): both sides take an FFT or a DFT
product in float32, which round differently.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audio_tpu.functional as JF
from audio_tpu._internal import windows as jwin
from audio_tpu.functional._stft import _pad_center as jax_pad_center
from audio_tpu.ops.pallas_spectrogram import power_spectrogram_pallas
from audio_tpu.ops.pallas_spectrogram import spectrogram_pallas_supported as jax_supported

import audio_tpu_torch.functional as TF
from audio_tpu_torch._internal import windows as twin
from audio_tpu_torch.functional import _spectral
from audio_tpu_torch.functional._stft import _pad_center
from audio_tpu_torch.ops import cuda_spectrogram
from audio_tpu_torch.ops.cuda_spectrogram import (
    _dft_basis,
    _windowed_operator,
    power_spectrogram_plain,
    spectrogram_supported,
)

CPU = torch.device("cpu")


def _np(x):
    return np.array(x, dtype=np.float32)


def _assert_peak_close(got, ref, frac=5e-4):
    got, ref = np.asarray(got), _np(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=frac * float(np.abs(ref).max()))


@pytest.mark.parametrize("name", ["hann", "hamming", "blackman", "bartlett", "kaiser"])
@pytest.mark.parametrize("periodic", [True, False])
def test_windows_match_jax(name, periodic):
    ref = _np(jwin.get_window(name, 64, periodic=periodic))
    got = twin.get_window(name, 64, periodic=periodic, device=CPU)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_povey_window_matches_jax():
    np.testing.assert_array_equal(twin.povey_window(400, device=CPU).numpy(), _np(jwin.povey_window(400)))


@pytest.mark.parametrize("norm,mel_scale", [(None, "htk"), ("slaney", "slaney"), ("slaney", "htk")])
def test_melscale_fbanks_match_jax(norm, mel_scale):
    ref = _np(JF.melscale_fbanks(201, 0.0, 8000.0, 80, 16000, norm=norm, mel_scale=mel_scale))
    got = TF.melscale_fbanks(201, 0.0, 8000.0, 80, 16000, norm=norm, mel_scale=mel_scale, device=CPU)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_linear_fbanks_and_dct_match_jax():
    np.testing.assert_array_equal(
        TF.linear_fbanks(257, 0.0, 8000.0, 40, 16000, device=CPU).numpy(),
        _np(JF.linear_fbanks(257, 0.0, 8000.0, 40, 16000)),
    )
    for norm in (None, "ortho"):
        np.testing.assert_array_equal(TF.create_dct(13, 40, norm, device=CPU).numpy(), _np(JF.create_dct(13, 40, norm)))


def test_stft_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    w = twin.hann_window(256, device=CPU)
    ref = np.asarray(JF.stft(jnp.asarray(x), 256, 64, window=jwin.hann_window(256)))
    got = TF.stft(torch.from_numpy(x), 256, 64, window=w).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref.astype(np.complex64), rtol=0, atol=5e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize(
    "power,normalized,pad",
    [(2.0, False, 0), (1.0, False, 0), (2.0, True, 0), (2.0, "frame_length", 3), (1.0, "window", 0)],
)
def test_spectrogram_matches_jax(power, normalized, pad):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4000)).astype(np.float32) * 0.3
    kw = dict(pad=pad, n_fft=400, hop_length=160, win_length=400, power=power, normalized=normalized)
    ref = JF.spectrogram(jnp.asarray(x), window=jwin.hann_window(400), **kw)
    got = TF.spectrogram(torch.from_numpy(x), window=twin.hann_window(400, device=CPU), **kw)
    assert got.dtype == torch.float32
    _assert_peak_close(got.numpy(), ref)


def test_complex_spectrogram_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 2000)).astype(np.float32)
    ref = np.asarray(JF.spectrogram(jnp.asarray(x), n_fft=256, hop_length=128, power=None))
    got = TF.spectrogram(torch.from_numpy(x), n_fft=256, hop_length=128, power=None).numpy()
    assert np.iscomplexobj(got) and got.shape == ref.shape
    np.testing.assert_allclose(got, ref.astype(np.complex64), rtol=0, atol=5e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("time_major,normalized", [(True, False), (False, False), (True, "window")])
def test_mel_spectrogram_matches_jax(time_major, normalized):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    fb = _np(JF.melscale_fbanks(201, 0.0, 8000.0, 80, 16000))
    kw = dict(n_fft=400, hop_length=160, win_length=400, normalized=normalized, time_major=time_major)
    ref = JF.mel_spectrogram(jnp.asarray(x), fb=jnp.asarray(fb), window=jwin.hann_window(400), **kw)
    got = TF.mel_spectrogram(torch.from_numpy(x), fb=torch.from_numpy(fb),
                             window=twin.hann_window(400, device=CPU), **kw)
    _assert_peak_close(got.numpy(), ref)


@pytest.mark.parametrize("n_fft,hop,t,power,mel", [
    (400, 160, 4000, 2.0, True), (400, 160, 4000, 2.0, False), (512, 128, 3000, 1.0, False),
])
def test_plain_version_matches_pallas_interpret(n_fft, hop, t, power, mel):
    """K2's plain version against the TPU kernel run in interpret mode."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, t)).astype(np.float32) * 0.3
    xp = _np(jax_pad_center(jnp.asarray(x), n_fft // 2, "reflect"))
    n_freq = n_fft // 2 + 1
    fb = _np(JF.melscale_fbanks(n_freq, 0.0, 8000.0, 80, 16000)) if mel else None
    w = _np(jwin.hann_window(n_fft))
    ref = power_spectrogram_pallas(jnp.asarray(xp), jnp.asarray(w), n_fft, hop, power,
                                   fb=None if fb is None else jnp.asarray(fb), interpret=True)
    before = cuda_spectrogram.launches
    got = cuda_spectrogram.power_spectrogram(torch.from_numpy(xp), torch.from_numpy(w), n_fft, hop, power,
                                             fb=None if fb is None else torch.from_numpy(fb))
    assert cuda_spectrogram.launches == before  # a CPU tensor never launches
    _assert_peak_close(got.numpy(), ref)


@pytest.mark.parametrize("n_fft", [400, 512])
def test_dft_operator_layout(n_fft):
    """The interleaved operator the kernel takes gives the plain version's power."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3 * n_fft)).astype(np.float32))
    w = twin.hann_window(n_fft, device=CPU)
    d = _windowed_operator(w, n_fft)
    assert d.shape == _dft_basis(n_fft, CPU).shape
    assert d.shape[0] % 16 == 0 and d.shape[1] % 64 == 0
    frames = torch.nn.functional.pad(x.unfold(-1, n_fft, 160), (0, d.shape[0] - n_fft))
    spec = (frames.double() @ d.double())
    power = spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2
    n_freq = n_fft // 2 + 1
    assert float(power[..., n_freq:].abs().max()) == 0.0
    ref = power_spectrogram_plain(x, w, n_fft, 160)
    _assert_peak_close(power[..., :n_freq].float().numpy(), ref.numpy())


def test_windowed_operator_cache():
    """One operator per live, unmodified window; a write or a new window rebuilds it."""
    w = twin.hann_window(400, device=CPU)
    d = _windowed_operator(w, 400)
    assert _windowed_operator(w, 400) is d
    w.mul_(0.5)  # bumps the version
    d_half = _windowed_operator(w, 400)
    assert d_half is not d
    torch.testing.assert_close(d_half, 0.5 * d, rtol=0, atol=0)
    other = twin.hann_window(400, device=CPU)
    assert _windowed_operator(other, 400) is not d_half
    with torch.inference_mode():
        w_inf = twin.hann_window(400, device=CPU)
        torch.testing.assert_close(_windowed_operator(w_inf, 400), d, rtol=0, atol=0)


def test_spectrogram_goes_through_the_kernel_wrapper(monkeypatch):
    """Supported configs take K2's glue and wrapper on the CPU too; others the STFT."""
    calls = []
    real = cuda_spectrogram.power_spectrogram

    def spy(*args, **kwargs):
        calls.append(args[2:5])
        return real(*args, **kwargs)

    monkeypatch.setattr(_spectral, "power_spectrogram", spy)
    x = torch.zeros((2, 1000))
    TF.spectrogram(x, n_fft=400, hop_length=160, power=1.0)
    TF.mel_spectrogram(x, fb=TF.melscale_fbanks(201, 0.0, 8000.0, 40, 16000, device=CPU))
    assert calls == [(400, 160, 1.0), (400, 200, 2.0)]
    TF.spectrogram(x, n_fft=400, hop_length=160, power=0.5)  # K2 takes power 1 or 2 only
    TF.spectrogram(x, n_fft=400, hop_length=160, onesided=False)
    assert len(calls) == 2


def test_supported_configs_agree_with_jax():
    for n_fft, hop, power in [(400, 160, 2.0), (512, 128, 1.0), (1024, 256, 2.0), (400, 160, 0.5),
                              (4096, 512, 2.0), (400, 8, 2.0), (256, 64, 2.0)]:
        assert spectrogram_supported(n_fft, hop, power) == jax_supported(n_fft, hop, power)


def test_pad_center_matches_jax():
    x = np.arange(30, dtype=np.float32).reshape(2, 15)
    for mode in ("reflect", "constant", "replicate", "circular"):
        ref = _np(jax_pad_center(jnp.asarray(x), 4, mode))
        np.testing.assert_array_equal(_pad_center(torch.from_numpy(x), 4, mode).numpy(), ref)
    with pytest.raises(ValueError):
        _pad_center(torch.from_numpy(x), 4, "bogus")
