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
from audio_tpu.functional._spectral import _power_spec_ref_tm
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
    _fft_plan_words,
    _fft_smem_bytes,
    _mel_words,
    _windowed_operator,
    fb_bands,
    fft_frames_per_block,
    fft_plan,
    kernel_route,
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


# ------------------------------------------------------------------ K2's "fft" route: host-side plan
def _staged_rfft(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The "fft" route's arithmetic in plain PyTorch, complex64: pack sample pairs in the
    plan's digit-reversed order, run its stages in place (twiddles from its float32 table,
    then each radix's DFT), split into the n_fft / 2 + 1 bins with its post-twiddles."""
    plan = fft_plan(n_fft)
    n = n_fft // 2
    z = torch.complex(frames[..., 0::2], frames[..., 1::2])[..., torch.as_tensor(plan["perm"]).long()]
    tw = torch.as_tensor(plan["twiddles"])
    lp = 1
    for r, off in zip(plan["radices"], plan["offsets"]):
        y = z.reshape(*z.shape[:-1], n // (lp * r), r, lp)  # position g L + m Lp + j
        t = torch.cat([torch.ones(1, lp, dtype=torch.complex64), tw[off: off + lp * (r - 1)].reshape(r - 1, lp)])
        q = torch.arange(r)
        ang = 2 * np.pi * ((q[:, None] * q[None, :]) % r) / r
        dft = torch.complex(torch.cos(ang).float(), -torch.sin(ang).float())
        z = torch.einsum("qm,...mj->...qj", dft, y * t).reshape(z.shape)
        lp *= r
    f = torch.arange(n + 1)
    zf, zr = z[..., f % n], z[..., (n - f) % n]
    return (zf + zr.conj()) / 2 + torch.as_tensor(plan["post"]) * ((zf - zr.conj()) / 2j)


@pytest.mark.parametrize("n_fft", [320, 400, 480, 512, 1024, 2048])
def test_fft_plan_matches_rfft_and_jax(n_fft):
    """The staged FFT of the plan gives rfft's bins and the JAX reference's power (1e-5 of the peak)."""
    rng = np.random.default_rng(n_fft)
    hop = n_fft // 4
    x = rng.standard_normal((2, 3 * n_fft)).astype(np.float32) * 0.3
    w = _np(jwin.hann_window(n_fft))
    frames = torch.from_numpy(x).unfold(-1, n_fft, hop) * torch.from_numpy(w)
    got = _staged_rfft(frames, n_fft)
    ref = torch.fft.rfft(frames.double())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    power = (got.real ** 2 + got.imag ** 2).numpy()
    _assert_peak_close(power, _power_spec_ref_tm(jnp.asarray(x), jnp.asarray(w), None, n_fft, hop, 2.0), 1e-5)


def test_fft_plan_tables():
    """Digit reversal is a permutation; radices multiply to n_fft / 2; tables are float32 casts."""
    for n_fft in (320, 400, 480, 512, 1024, 1200, 2048):
        plan = fft_plan(n_fft)
        assert int(np.prod(plan["radices"])) == n_fft // 2 and set(plan["radices"]) <= {2, 3, 4, 5, 8}
        assert sorted(plan["perm"].tolist()) == list(range(n_fft // 2))
        assert plan["twiddles"].dtype == np.complex64 and plan["post"].shape == (n_fft // 2 + 1,)
        np.testing.assert_allclose(plan["post"], np.exp(-2j * np.pi * np.arange(n_fft // 2 + 1) / n_fft), atol=1e-7)
        # the butterflies of each stage touch every slot once: (g L + j) + m Lp over q and m
        lp = 1
        for r, off in zip(plan["radices"], plan["bf_offsets"]):
            flies = plan["butterflies"][off: off + n_fft // 2 // r]
            base, j = flies & 0xFFFF, flies >> 16
            if lp == 1:  # the first stage holds its first sample pair; the others lie N / r apart
                np.testing.assert_array_equal(j, plan["perm"][base])
                perm = plan["perm"].reshape(-1, r)
                np.testing.assert_array_equal(perm, perm[:, :1] + (n_fft // 2 // r) * np.arange(r))
            else:
                assert (j < lp).all() and (base % (lp * r) == j).all()
            assert sorted((base[:, None] + lp * np.arange(r)).reshape(-1).tolist()) == list(range(n_fft // 2))
            lp *= r
    assert fft_plan(400)["radices"] == (8, 5, 5)


def test_kernel_route():
    assert [kernel_route(n) for n in (400, 320, 480, 512, 1024, 2048, 1200)] == ["fft"] * 7
    assert [kernel_route(n) for n in (398, 401, 2 * 7 * 16, 2 * 11)] == ["dft"] * 4
    with pytest.raises(ValueError):
        fft_plan(398)


@pytest.mark.parametrize("n_fft,hop,n_frames,mel", [
    (400, 160, 101, True), (400, 160, 101, False), (2048, 512, 30, True), (2048, 32, 1000, True), (512, 128, 3, False),
    (512, 128, 126, True), (1024, 256, 63, True), (1024, 256, 63, False), (320, 160, 1, True), (480, 160, 99, False),
    (1200, 300, 51, True), (2048, 2048, 7, False), (400, 32, 495, True), (2048, 512, 1, False), (320, 80, 200, False),
])
def test_fft_frames_per_block(n_fft, hop, n_frames, mel):
    """A block's frames fill whole warps (16 threads a frame), fit the shared memory a block can
    take and are evened out over the stream."""
    table = 3000  # words of plan and mel table a block copies
    f = fft_frames_per_block(n_fft, hop, n_frames, mel, table)
    assert 1 <= f <= 8 and f % 2 == 0 and _fft_smem_bytes(n_fft, hop, f, table, mel) <= 232448
    chunks = -(-n_frames // f)
    assert chunks * f - n_frames < chunks * 2  # at most a warp's frames short of even
    if (n_fft, hop, n_frames) == (400, 160, 101):
        assert f == 8  # 13 blocks a stream, 104 frame slots for 101 frames


def test_fft_smem_bytes():
    """The shared memory of an "fft" block (csrc/spectrogram.cu: fft_smem): the tables, the
    block's span of samples rounded to 16 bytes with 4 words to start on the signal's phase, the
    padded transforms and the power spectra of the mel product."""
    span = 7 * 160 + 400
    base = 4 * (100 + span + 4) + 8 * 8 * (200 + 25 + 1)
    assert _fft_smem_bytes(400, 160, 8, 100, False) == base
    assert _fft_smem_bytes(400, 160, 8, 100, True) == base + 4 * 8 * 201
    assert _fft_smem_bytes(400, 150, 1, 0, False) == 4 * (400 + 4) + 8 * 226


@pytest.mark.parametrize("kind", ["mel", "dense"])
def test_fb_bands(kind):
    """Each column's band holds all its non-zeros; a mel product over the bands is the dense one."""
    rng = np.random.default_rng(9)
    if kind == "mel":
        fb = _np(JF.melscale_fbanks(201, 0.0, 8000.0, 80, 16000))
    else:
        fb = rng.standard_normal((201, 40)).astype(np.float32)
    fbt = torch.from_numpy(fb)
    bands = fb_bands(fbt)
    assert bands.dtype == torch.int32 and bands.shape == (fb.shape[1], 2)
    for c, (lo, hi) in enumerate(bands.tolist()):
        nz = np.flatnonzero(fb[:, c])
        assert (lo, hi) == ((int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0))
    if kind == "dense":
        assert bands.tolist() == [[0, 201]] * 40
    else:
        assert int((bands[:, 1] - bands[:, 0]).sum()) < 2 * 201  # a triangular bank: about two bins' worth a bin
    p = torch.from_numpy(rng.random((5, 201)).astype(np.float32))
    banded = torch.stack([(p[:, lo:hi] * fbt[lo:hi, c]).sum(-1) for c, (lo, hi) in enumerate(bands.tolist())], -1)
    dense = p @ fbt
    assert float((banded - dense).abs().max()) <= 1e-6 * float(dense.abs().max())


def test_fb_bands_of_a_zero_column():
    fb = torch.zeros(10, 3)
    fb[2:5, 0] = 1.0
    fb[9, 2] = 0.5
    assert fb_bands(fb).tolist() == [[2, 5], [0, 0], [9, 10]]


def test_fft_plan_words_layout():
    """The words a block copies hold the plan's sections where the offsets say, 16-byte aligned."""
    w = twin.hann_window(400, device=CPU)
    words, starts, radices, bf_offsets, tw_offsets = _fft_plan_words(w, 400)
    plan = fft_plan(400)
    assert words.dtype == torch.float32 and words.numel() % 4 == 0 and all(s % 4 == 0 for s in starts)
    assert list(radices) == list(plan["radices"]) and list(bf_offsets) == list(plan["bf_offsets"])
    assert list(tw_offsets) == list(plan["offsets"])
    ints = words.view(torch.int32)
    np.testing.assert_array_equal(ints[: plan["butterflies"].size].numpy(), plan["butterflies"])
    torch.testing.assert_close(words[starts[0]: starts[0] + 400], w, rtol=0, atol=0)
    tw = words[starts[1]: starts[1] + 2 * plan["twiddles"].size].view(-1, 2)
    np.testing.assert_array_equal(tw[:, 0].numpy() + 1j * tw[:, 1].numpy(), plan["twiddles"])
    post = words[starts[2]: starts[2] + 2 * 201].view(-1, 2)
    np.testing.assert_array_equal(post[:, 0].numpy() + 1j * post[:, 1].numpy(), plan["post"])
    assert _fft_plan_words(w, 400)[0] is words  # cached with the window
    assert _mel_words(TF.melscale_fbanks(201, 0.0, 8000.0, 80, 16000, device=CPU))[0] is not None


@pytest.mark.parametrize("kind", ["mel", "dense"])
def test_mel_words_give_the_dense_product(kind):
    """The kernel's mel loop over the table's words (first bin, weight starts, weights) is the
    dense product to 1e-6 of the peak."""
    rng = np.random.default_rng(11)
    fb = (TF.melscale_fbanks(201, 0.0, 8000.0, 80, 16000, device=CPU) if kind == "mel"
          else torch.from_numpy(rng.standard_normal((201, 24)).astype(np.float32)))
    words, (off_start, off_w) = _mel_words(fb)
    n_mels = fb.shape[1]
    ints = words.view(torch.int32)
    first, start, w = ints[:n_mels], ints[off_start: off_start + n_mels + 1], words[off_w:]
    p = torch.from_numpy(rng.random((3, 201)).astype(np.float32))
    got = torch.zeros(3, n_mels)
    for c in range(n_mels):
        n = int(start[c + 1] - start[c])
        got[:, c] = (p[:, int(first[c]): int(first[c]) + n] * w[int(start[c]): int(start[c + 1])]).sum(-1)
    dense = p @ fb
    assert float((got - dense).abs().max()) <= 1e-6 * float(dense.abs().max())
    assert int(start[-1]) == int((fb_bands(fb)[:, 1] - fb_bands(fb)[:, 0]).sum())
