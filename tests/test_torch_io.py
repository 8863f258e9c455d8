"""The port's ``io`` (WAV, FLAC, SPHERE, AU, the FFmpeg and torchcodec shims) against ``audio_tpu.io``.

Every file is written by the test under ``tmp_path``.  Both packages read the same bytes: the port's waveform (a CPU
tensor) must equal the JAX package's numpy array bit for bit and in type, for every WAV format (PCM 8/16/24/32-bit,
float 32/64, WAVE_FORMAT_EXTENSIBLE), with ``frame_offset``, ``num_frames``, ``normalize`` and ``channels_first``;
``info``'s five fields equal.  FLAC: the port's encoder writes the JAX encoder's bytes, its streams decode to the
input in both decoders, and the JAX encoder's in the port's, over odd block sizes, stereo decorrelation, wasted bits,
partition orders, verbatim frames and LPC orders up to 32.  With neither ``ffmpeg`` nor ``soundfile`` present, an MP3
raises the JAX package's error.
"""

import shutil
import struct
import sys
import warnings

import numpy as np
import pytest
import torch

import audio_tpu.io as jio
from audio_tpu.io import _flac as j_flac

import audio_tpu_torch.io as tio
from audio_tpu_torch.io import _flac as t_flac

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


def _signal(n, nch, bits, seed=0):
    """The JAX codec test's integer signal: a sine in noise, each channel rolled and scaled, a constant start."""
    rng = np.random.default_rng(seed)
    amp = 2 ** (bits - 1) - 1
    t = np.arange(n)
    x = np.clip((np.sin(2 * np.pi * t / 50) * 0.4 + 0.05 * rng.standard_normal(n)) * amp, -amp, amp).astype(np.int64)
    x = np.stack([np.roll(x, 3 * i) // (i + 1) for i in range(nch)], 1)
    x[:64] = 1 if bits <= 8 else 42
    return x


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.from_numpy(np.zeros(0, want.dtype)).dtype, (got.dtype, want.dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _same_info(path):
    a, b = tio.info(path), jio.info(path)
    fields = ("sample_rate", "num_frames", "num_channels", "bits_per_sample", "encoding")
    assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]
    assert [type(getattr(a, f)) for f in fields] == [type(getattr(b, f)) for f in fields]
    return a


def _raw_wav(path, fmt_code, bits, rate, data: bytes, nch: int, extensible=False):
    block = nch * bits // 8
    if extensible:
        fmt = struct.pack("<HHIIHH", 0xFFFE, nch, rate, rate * block, block, bits)
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_code) + b"\x00" * 14
    else:
        fmt = struct.pack("<HHIIHH", fmt_code, nch, rate, rate * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _write_wav(path, kind, x):
    """``x`` (channels, frames) float in [-1, 1) as one of the WAV formats, through ``save`` where it writes it."""
    nch = x.shape[0]
    if kind in ("PCM_S16", "PCM_S32", "PCM_F32", "PCM_U8"):
        enc, bits = {"PCM_S16": ("PCM_S", 16), "PCM_S32": ("PCM_S", 32), "PCM_F32": ("PCM_F", 32),
                     "PCM_U8": ("PCM_U", 8)}[kind]
        tio.save(path, torch.from_numpy(x), 16000, encoding=enc, bits_per_sample=bits)
    elif kind == "PCM_S24":
        v = np.clip(np.round(x.T * 8388607), -8388608, 8388607).astype(np.int32).reshape(-1)
        data = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], 1).astype(np.uint8).tobytes()
        _raw_wav(path, 1, 24, 16000, data, nch)
    elif kind == "PCM_F64":
        _raw_wav(path, 3, 64, 16000, x.T.astype("<f8").tobytes(), nch)
    elif kind == "EXTENSIBLE":
        _raw_wav(path, 1, 16, 16000, np.round(x.T * 32767).astype("<i2").tobytes(), nch, extensible=True)


WAV_KINDS = ["PCM_S16", "PCM_S32", "PCM_F32", "PCM_U8", "PCM_S24", "PCM_F64", "EXTENSIBLE"]


@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("kind", WAV_KINDS)
def test_wav_loads_as_the_jax_package_loads_it(tmp_path, kind, nch):
    x = (0.4 * np.random.default_rng(nch).standard_normal((nch, 2001))).clip(-1, 0.99).astype(np.float32)
    path = str(tmp_path / "a.wav")
    _write_wav(path, kind, x)
    info = _same_info(path)
    assert (info.num_frames, info.num_channels) == (2001, nch)
    for kw in ({}, {"normalize": False}, {"channels_first": False}, {"frame_offset": 100, "num_frames": 333},
               {"frame_offset": 1990}, {"num_frames": 0}):
        got, sr = tio.load(path, **kw)
        want, jsr = jio.load(path, **kw)
        assert sr == jsr == 16000 and type(sr) is type(jsr)
        _same(got, want)


def test_save_takes_tensors_arrays_and_half_types_alike(tmp_path):
    x = (0.3 * np.random.default_rng(0).standard_normal((2, 500))).astype(np.float32)
    for i, src in enumerate((x, torch.from_numpy(x))):
        tio.save(str(tmp_path / f"{i}.wav"), src, 8000)
        jio.save(str(tmp_path / f"j{i}.wav"), x, 8000)
    assert (tmp_path / "0.wav").read_bytes() == (tmp_path / "1.wav").read_bytes() == (tmp_path / "j0.wav").read_bytes()
    tio.save(str(tmp_path / "h.wav"), torch.from_numpy(x).to(torch.bfloat16), 8000)
    jio.save(str(tmp_path / "jh.wav"), torch.from_numpy(x).to(torch.bfloat16).float().numpy(), 8000)
    assert (tmp_path / "h.wav").read_bytes() == (tmp_path / "jh.wav").read_bytes()


FLAC_CASES = {
    "mono 16": (10000, 1, 16, {}),
    "stereo lpc": (10000, 2, 16, {"use_lpc": True}),
    "left-side": (10000, 2, 16, {"stereo_mode": "left_side"}),
    "mid-side": (10000, 2, 16, {"stereo_mode": "mid_side"}),
    "24-bit": (4096, 1, 24, {}),
    "8-bit odd": (777, 2, 8, {}),
    "tiny": (50, 1, 16, {}),
    "partitions": (8192, 1, 16, {"partition_order": 3}),
    "verbatim": (4096, 2, 16, {"force_verbatim": True}),
    "12-bit": (9000, 1, 12, {}),
    "20-bit": (6000, 1, 20, {"partition_order": 2}),
    "4 channels": (6000, 4, 16, {}),
    "odd blocks": (5000, 1, 16, {"block_size": 1153}),
    "32-bit": (3000, 1, 32, {"use_lpc": False}),
}


@pytest.mark.parametrize("case", list(FLAC_CASES))
def test_flac_encoders_agree_and_both_decoders_read_both(case):
    n, nch, bits, kw = FLAC_CASES[case]
    x = _signal(n, nch, bits)
    if case == "mono 16":
        x = (x >> 3) << 3  # wasted bits
    enc = t_flac.encode_flac(x, 16000, bits_per_sample=bits, **kw)
    assert enc == j_flac.encode_flac(x, 16000, bits_per_sample=bits, **kw)
    assert t_flac.probe_flac(enc) == j_flac.probe_flac(enc) == (16000, nch, bits, n)
    for decode in (t_flac.decode_flac, j_flac.decode_flac):
        dec, rate, b = decode(enc)
        assert (rate, b) == (16000, bits)
        np.testing.assert_array_equal(dec.astype(np.int64), x)


@pytest.mark.parametrize("order", [5, 17, 32])
def test_lpc_subframes_up_to_order_32_decode_in_both(order, monkeypatch):
    """The encoders write order-8 LPC; the decoders take orders up to 32.  Streams of a forced order (above the fixed
    predictors' 4, so a residual of that order is an LPC subframe), written by the JAX encoder, decode to the input
    in the port's decoder and the JAX one's."""
    x = _signal(6000, 1, 16, seed=order)
    lpc, residual, written = j_flac._lpc_analyze, j_flac._write_residual, []
    monkeypatch.setattr(j_flac, "_lpc_analyze", lambda xs, order=8, precision=12: lpc(xs, forced, precision))
    monkeypatch.setattr(j_flac, "_write_residual", lambda bw, res, o, *a: (written.append(o), residual(bw, res, o, *a)))
    forced = order
    enc = j_flac.encode_flac(x, 16000, bits_per_sample=16, use_lpc=True)
    assert order in written
    for decode in (t_flac.decode_flac, j_flac.decode_flac):
        np.testing.assert_array_equal(decode(enc)[0].astype(np.int64), x)


def test_flac_through_load_save_and_info(tmp_path):
    x = (0.5 * np.sin(2 * np.pi * 440 * np.arange(8000) / 16000)).astype(np.float32)[None]
    tio.save(str(tmp_path / "t.flac"), torch.from_numpy(x), 16000)
    jio.save(str(tmp_path / "j.flac"), x, 16000)
    assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()
    path = str(tmp_path / "t.flac")
    assert _same_info(path).encoding == "FLAC"
    for kw in ({}, {"normalize": False}, {"frame_offset": 100, "num_frames": 50}, {"channels_first": False}):
        got, sr = tio.load(path, **kw)
        want, _ = jio.load(path, **kw)
        assert sr == 16000
        _same(got, want)
    q = np.clip(np.round(x.astype(np.float64) * 32768), -32768, 32767) / 32768
    np.testing.assert_array_equal(tio.load(path)[0].numpy(), q.astype(np.float32))  # 16-bit quantisation, exactly
    for bits in (8, 24):
        tio.save(str(tmp_path / f"b{bits}.flac"), x, 16000, bits_per_sample=bits)
        _same(tio.load(str(tmp_path / f"b{bits}.flac"), normalize=False)[0],
              jio.load(str(tmp_path / f"b{bits}.flac"), normalize=False)[0])


def test_flac_build_raises_without_gxx(monkeypatch, tmp_path):
    """The decoder builds at first use; a missing compiler is an error, never a fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(t_flac, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(FileNotFoundError, match="g\\+\\+"):
        t_flac.build()


def _write_sph(path, pcm, rate, nch, coding="pcm", nbytes=2):
    header = (f"NIST_1A\n   1024\nsample_rate -i {rate}\nchannel_count -i {nch}\nsample_n_bytes -i {nbytes}\n"
              f"sample_byte_format -s2 01\nsample_coding -s{len(coding)} {coding}\nsample_count -i {pcm.size // nch}\n"
              "end_head\n").encode()
    with open(path, "wb") as f:
        f.write(header + b" " * (1024 - len(header)) + pcm.tobytes())


@pytest.mark.parametrize("kind", ["pcm16", "pcm16 stereo", "ulaw"])
def test_sphere_loads_as_the_jax_package_loads_it(tmp_path, kind):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "x.sph")
    if kind == "ulaw":
        _write_sph(path, rng.integers(0, 256, 3000).astype(np.uint8), 8000, 1, "ulaw", 1)
    else:
        nch = 2 if "stereo" in kind else 1
        _write_sph(path, (rng.standard_normal(3000 * nch) * 8000).astype("<i2"), 16000, nch)
    _same_info(path)
    for kw in ({}, {"frame_offset": 10, "num_frames": 100}, {"channels_first": False}):
        got, sr = tio.load(path, **kw)
        want, jsr = jio.load(path, **kw)
        assert sr == jsr
        _same(got, want)


@pytest.mark.parametrize("enc", [1, 2, 3, 4, 5, 6, 7])
def test_au_loads_as_the_jax_package_loads_it(tmp_path, enc):
    rng = np.random.default_rng(enc)
    nbytes = {1: 1, 2: 1, 3: 2, 4: 3, 5: 4, 6: 4, 7: 8}[enc]
    if enc == 6:
        body = (0.3 * rng.standard_normal(800)).astype(">f4").tobytes()
    elif enc == 7:
        body = (0.3 * rng.standard_normal(800)).astype(">f8").tobytes()
    else:
        body = rng.integers(0, 256, 800 * nbytes).astype(np.uint8).tobytes()
    path = str(tmp_path / "x.au")
    with open(path, "wb") as f:
        f.write(b".snd" + struct.pack(">IIIII", 24, len(body), enc, 22050, 1) + body)
    _same_info(path)
    got, sr = tio.load(path)
    want, jsr = jio.load(path)
    assert sr == jsr == 22050
    _same(got, want)


def test_other_containers_raise_the_jax_package_s_error_without_a_codec(tmp_path):
    assert shutil.which("ffmpeg") is None  # this environment has neither ffmpeg nor soundfile
    path = str(tmp_path / "x.mp3")
    with open(path, "wb") as f:
        f.write(b"ID3\x04\x00" + bytes(200))
    for fn in ("load", "info"):
        with pytest.raises(ValueError) as jerr:
            getattr(jio, fn)(path)
        with pytest.raises(ValueError) as terr:
            getattr(tio, fn)(path)
        assert str(terr.value) == str(jerr.value) and "ffmpeg" in str(terr.value)


def test_the_ffmpeg_fallback_runs_a_binary_on_path(tmp_path, monkeypatch):
    """A stand-in ``ffmpeg`` on ``PATH`` (the port reads no variable to find it): its f32le PCM comes back as a
    tensor, its probe's WAV header as ``info``."""
    pcm = (0.25 * np.sin(np.arange(3200) / 7.0)).astype("<f4").reshape(-1, 2)
    raw = tmp_path / "pcm.bin"
    pcm.tofile(raw)
    stub = tmp_path / "ffmpeg"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import struct, sys\n"
        "sys.stdin.buffer.read()\n"
        "if 'wav' in sys.argv:\n"
        "    sys.stdout.buffer.write(b'RIFF' + b'\\0' * 18 + struct.pack('<HI', 2, 44100) + b'\\0' * 14)\n"
        f"else:\n    sys.stdout.buffer.write(open({str(raw)!r}, 'rb').read())\n")
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    path = str(tmp_path / "x.ogg")
    with open(path, "wb") as f:
        f.write(b"OggS" + bytes(100))
    wav, sr = tio.load(path)
    assert sr == 44100 and wav.dtype == torch.float32 and tuple(wav.shape) == (2, 1600)
    np.testing.assert_array_equal(wav.numpy(), pcm.T)
    meta = tio.info(path)
    assert (meta.sample_rate, meta.num_channels) == (44100, 2)


def test_torchcodec_shims_warn_and_honour_as_the_jax_package_s(tmp_path):
    x = (0.2 * np.random.default_rng(0).standard_normal((1, 400))).astype(np.float32)
    tio.save_with_torchcodec(str(tmp_path / "a.wav"), torch.from_numpy(x), 8000, bits_per_sample=32, encoding="PCM_F")
    jio.save_with_torchcodec(str(tmp_path / "b.wav"), x, 8000, bits_per_sample=32, encoding="PCM_F")
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    for kw in ({"normalize": False}, {"buffer_size": 1024}, {"backend": "x"}):
        with pytest.warns(UserWarning) as tw:
            got, _ = tio.load_with_torchcodec(str(tmp_path / "a.wav"), **kw)
        with pytest.warns(UserWarning) as jw:
            want, _ = jio.load_with_torchcodec(str(tmp_path / "a.wav"), **kw)
        assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
        _same(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _same(tio.load_with_torchcodec(str(tmp_path / "a.wav"))[0], x)


def test_load_reads_file_objects(tmp_path):
    x = (0.2 * np.random.default_rng(1).standard_normal((2, 300))).astype(np.float32)
    tio.save(str(tmp_path / "a.flac"), x, 16000)
    with open(tmp_path / "a.flac", "rb") as f:
        got, sr = tio.load(f)
    _same(got, jio.load(str(tmp_path / "a.flac"))[0])
