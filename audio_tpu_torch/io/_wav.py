"""WAV codec with torchaudio's ``load``/``save``/``info`` contract, and the dispatch to the other codecs.

The same codec as ``audio_tpu.io._wav``: RIFF/WAVE PCM (8/16/24/32-bit int), IEEE float (32/64-bit) and
WAVE_FORMAT_EXTENSIBLE, read with numpy; FLAC, SPHERE and AU by magic bytes through ``_flac`` and ``_formats``; other
containers through an ``ffmpeg`` binary or the ``soundfile`` package.  ``load`` returns (waveform, sample_rate):
float32 normalised to [-1, 1) by default, channels first, the integer type of the file with ``normalize=False``.

``load`` decodes on the host and returns a CPU tensor, as torchaudio's does: the caller moves it to the card.  This is
file reading, not a compute path.  ``save`` takes a tensor on any device (or an array).
"""

from __future__ import annotations

import io
import os
import struct
import wave
from typing import BinaryIO, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["AudioMetaData", "info", "load", "save"]

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _parse_wav(data: bytes):
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    pos = 12
    fmt = None
    frames = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                (sub_format,) = struct.unpack("<H", body[24:26])
                fmt = (sub_format,) + fmt[1:]
        elif chunk_id == b"data":
            frames = body
        pos += 8 + chunk_size + (chunk_size % 2)
    if fmt is None or frames is None:
        raise ValueError("Malformed WAV: missing fmt or data chunk")
    return fmt, frames


class AudioMetaData:
    """Return type of :func:`info` (torchaudio's ``AudioMetaData`` fields)."""

    def __init__(self, sample_rate, num_frames, num_channels, bits_per_sample, encoding):
        self.sample_rate = sample_rate
        self.num_frames = num_frames
        self.num_channels = num_channels
        self.bits_per_sample = bits_per_sample
        self.encoding = encoding

    def __repr__(self):
        return (
            f"AudioMetaData(sample_rate={self.sample_rate}, num_frames={self.num_frames}, "
            f"num_channels={self.num_channels}, bits_per_sample={self.bits_per_sample}, "
            f"encoding={self.encoding!r})"
        )


_INFO_PREFIX = 65536  # covers FLAC STREAMINFO, SPHERE/AU/WAV headers


def _wav_header_info(data: bytes, file_size: int):
    """Header-only WAV metadata from a prefix: (fmt, data_size) without
    loading the sample bytes.  Returns None when the prefix doesn't reach
    the data chunk (caller falls back to a full read)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    pos = 12
    fmt = None
    while pos + 8 <= len(data):
        chunk_id = data[pos: pos + 4]
        (chunk_size,) = struct.unpack("<I", data[pos + 4: pos + 8])
        if chunk_id == b"fmt ":
            body = data[pos + 8: pos + 8 + chunk_size]
            if len(body) < 16:
                return None
            fmt = struct.unpack("<HHIIHH", body[:16])
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40 and len(body) >= 26:
                (sub_format,) = struct.unpack("<H", body[24:26])
                fmt = (sub_format,) + fmt[1:]
        elif chunk_id == b"data":
            if fmt is None:
                return None
            # clamp against the on-disk size (writers sometimes overstate)
            avail = max(0, file_size - pos - 8)
            return fmt, min(chunk_size, avail)
        pos += 8 + chunk_size + (chunk_size % 2)
    return None


def info(uri: Union[BinaryIO, str, os.PathLike], format: Optional[str] = None,
         buffer_size: int = 4096, backend: Optional[str] = None) -> AudioMetaData:
    """Metadata of an audio file without decoding the samples.

    For on-disk WAV/FLAC/SPHERE/AU this reads only a 64 KiB header prefix
    (metadata passes over large corpora stay I/O-cheap); other formats and
    file-like inputs fall back to a full read.
    """
    prefix = None
    if not hasattr(uri, "read"):
        try:
            file_size = os.path.getsize(uri)
            with open(uri, "rb") as f:
                prefix = f.read(_INFO_PREFIX)
            if prefix[:4] == b"RIFF":
                got = _wav_header_info(prefix, file_size)
                if got is not None:
                    fmt, data_size = got
                    audio_format, n_channels, sample_rate, _, block_align, bits = fmt
                    if audio_format == _WAVE_FORMAT_PCM:
                        encoding = "PCM_U" if bits == 8 else "PCM_S"
                    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
                        encoding = "PCM_F"
                    else:
                        encoding = "UNKNOWN"
                    num_frames = data_size // block_align if block_align else 0
                    return AudioMetaData(sample_rate, num_frames, n_channels, bits, encoding)
            elif prefix[:4] == b"fLaC":
                from ._flac import probe_flac

                try:
                    rate, nch, bits, total = probe_flac(prefix)
                    return AudioMetaData(rate, total, nch, bits, "FLAC")
                except ValueError:
                    if len(prefix) == _INFO_PREFIX:
                        pass  # STREAMINFO past the prefix; full-read fallback
                    else:
                        raise  # the whole file was read and it's invalid
            elif prefix[:7] == b"NIST_1A":
                from ._formats import sph_info

                rate, frames, nch, bits, enc = sph_info(prefix)
                return AudioMetaData(rate, frames, nch, bits, enc)
        except OSError:
            pass

    if hasattr(uri, "read"):
        data = uri.read()
    elif prefix is not None and len(prefix) < _INFO_PREFIX:
        data = prefix  # the prefix was already the whole file
    else:
        with open(uri, "rb") as f:
            data = f.read()
    if data[:4] == b"fLaC":
        from ._flac import probe_flac

        rate, nch, bits, total = probe_flac(data)
        return AudioMetaData(rate, total, nch, bits, "FLAC")
    if data[:7] == b"NIST_1A":
        from ._formats import sph_info

        rate, frames, nch, bits, enc = sph_info(data)
        return AudioMetaData(rate, frames, nch, bits, enc)
    if data[:4] == b".snd":
        from ._formats import au_info

        rate, frames, nch, bits, enc = au_info(data)
        return AudioMetaData(rate, frames, nch, bits, enc)
    if data[:4] != b"RIFF":
        from ._ffmpeg import ffmpeg_available, probe_with_ffmpeg

        if ffmpeg_available():
            m = probe_with_ffmpeg(data, format=format)
            return AudioMetaData(
                m["sample_rate"], m["num_frames"], m["num_channels"], m["bits_per_sample"], m["encoding"]
            )
        try:
            import soundfile as sf

            si = sf.info(io.BytesIO(data))
            return AudioMetaData(
                int(si.samplerate), int(si.frames), int(si.channels), 0, si.format
            )
        except ImportError as err:
            # same message load() raises for the same input, not a
            # misleading "Malformed WAV" from the RIFF parser below
            raise ValueError(
                "Built-in codecs handle WAV/FLAC/SPHERE/AU; install an ffmpeg "
                "binary or the soundfile package for other formats"
            ) from err
    fmt, frames = _parse_wav(data)
    audio_format, n_channels, sample_rate, _, block_align, bits = fmt
    if audio_format == _WAVE_FORMAT_PCM:
        encoding = "PCM_U" if bits == 8 else "PCM_S"
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        encoding = "PCM_F"
    else:
        encoding = "UNKNOWN"
    num_frames = len(frames) // block_align if block_align else 0
    return AudioMetaData(sample_rate, num_frames, n_channels, bits, encoding)


def _decode(fmt, frames: bytes) -> Tuple[np.ndarray, int, int]:
    audio_format, n_channels, sample_rate, _, block_align, bits = fmt
    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 8:
            x = np.frombuffer(frames, dtype=np.uint8).astype(np.int16) - 128
            x = x.astype(np.float32) / 128.0
            raw = np.frombuffer(frames, dtype=np.uint8)
        elif bits == 16:
            raw = np.frombuffer(frames, dtype="<i2")
            x = raw.astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(frames, dtype=np.uint8).reshape(-1, 3)
            raw = (
                b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) | (b[:, 2].astype(np.int32) << 16)
            )
            raw = ((raw << 8) >> 8) << 8  # sign-extend, left-justify as int32
            x = raw.astype(np.float32) / 2147483648.0
        elif bits == 32:
            raw = np.frombuffer(frames, dtype="<i4")
            x = raw.astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(frames, dtype=dtype).astype(np.float32)
        raw = x
    else:
        raise ValueError(f"Unsupported WAV format code: {audio_format:#x}")
    x = x.reshape(-1, n_channels)
    raw = raw.reshape(-1, n_channels)
    return x, sample_rate, bits, raw


def load(
    uri: Union[BinaryIO, str, os.PathLike],
    frame_offset: int = 0,
    num_frames: int = -1,
    normalize: bool = True,
    channels_first: bool = True,
    format: Optional[str] = None,
    buffer_size: int = 4096,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, int]:
    """Load audio; returns (waveform float32 [channel, time] on the CPU, sample_rate)."""
    if hasattr(uri, "read"):
        data = uri.read()
    else:
        with open(uri, "rb") as f:
            data = f.read()
    if data[:4] == b"RIFF":
        fmt, frames = _parse_wav(data)
        x, sample_rate, _, raw = _decode(fmt, frames)
        if not normalize and fmt[0] == _WAVE_FORMAT_PCM:
            x = raw  # torchaudio contract: raw integer dtype (uint8/int16/int32)
    elif data[:4] == b"fLaC":
        from ._flac import decode_flac

        pcm, sample_rate, bits = decode_flac(data)
        if normalize:
            x = pcm.astype(np.float32) / float(1 << (bits - 1))
        elif bits == 8:
            x = (pcm + 128).astype(np.uint8)  # WAV-path raw-int contract
        elif bits <= 16:
            x = (pcm << (16 - bits)).astype(np.int16)
        else:
            x = (pcm << (32 - bits)).astype(np.int32)  # left-justified, as WAV 24-bit
    elif data[:7] == b"NIST_1A":
        from ._formats import parse_sph

        x, sample_rate, _, _ = parse_sph(data)
    elif data[:4] == b".snd":
        from ._formats import parse_au

        x, sample_rate, _, _ = parse_au(data)
    else:
        # unknown container (mp3/ogg/...): ffmpeg CLI, then soundfile (the
        # torchaudio needs FFmpeg through torchcodec for these too)
        from ._ffmpeg import decode_with_ffmpeg, ffmpeg_available

        if ffmpeg_available():
            x, sample_rate = decode_with_ffmpeg(data, format=format)
        else:
            try:
                import soundfile as sf

                x, sample_rate = sf.read(io.BytesIO(data), dtype="float32", always_2d=True)
            except ImportError as err:
                raise ValueError(
                    "Built-in codecs handle WAV/FLAC/SPHERE/AU; install an ffmpeg "
                    "binary or the soundfile package for other formats"
                ) from err
    if frame_offset > 0:
        x = x[frame_offset:]
    if num_frames >= 0:
        x = x[:num_frames]
    if channels_first:
        x = np.ascontiguousarray(x.T)
    if x.dtype.kind == "f":
        x = x.astype(np.float32)
    if not x.flags.writeable:  # a view of the file's bytes
        x = x.copy()
    return torch.from_numpy(x), sample_rate


def save(
    uri: Union[str, os.PathLike],
    src,
    sample_rate: int,
    channels_first: bool = True,
    format: Optional[str] = None,
    encoding: Optional[str] = None,
    bits_per_sample: Optional[int] = None,
    buffer_size: int = 4096,
    backend: Optional[str] = None,
    compression=None,
) -> None:
    """Save a waveform to WAV (PCM_S 16/32 or PCM_F) or FLAC (by extension)."""
    if isinstance(src, torch.Tensor):
        src = src.detach().cpu()
        src = src.float() if src.dtype in (torch.float16, torch.bfloat16) else src
        src = src.numpy()
    x = np.asarray(src)
    if x.ndim == 1:
        x = x[None] if channels_first else x[:, None]
    if channels_first:
        x = x.T  # (time, channel)
    fmt_name = (format or os.path.splitext(str(uri))[1].lstrip(".")).lower()
    if fmt_name == "flac":
        from ._flac import encode_flac

        if x.dtype.kind == "f":
            bits = bits_per_sample or 16
            amp = float((1 << (bits - 1)) - 1)
            pcm = np.clip(np.round(x * (1 << (bits - 1))), -amp - 1, amp).astype(np.int64)
        else:
            # integer input: native width, rescaled if an explicit narrower /
            # wider bits_per_sample was requested
            native = 8 * x.dtype.itemsize
            pcm = x.astype(np.int64)
            if x.dtype == np.uint8:
                pcm -= 128
            bits = bits_per_sample or min(native, 24)
            if bits < native:
                pcm >>= native - bits
            elif bits > native:
                pcm <<= bits - native
        with open(uri, "wb") as f:
            f.write(encode_flac(pcm, sample_rate, bits_per_sample=bits))
        return
    bits = bits_per_sample or 16
    enc = encoding or ("PCM_S" if bits in (16, 24, 32) else "PCM_F")
    if enc == "PCM_F" or bits == 64:
        audio_format, dtype, bits = _WAVE_FORMAT_IEEE_FLOAT, "<f4", 32
        frames = x.astype(dtype).tobytes()
    elif bits == 16:
        audio_format = _WAVE_FORMAT_PCM
        frames = (np.clip(x, -1, 1) * 32767.0).astype("<i2").tobytes()
    elif bits == 32:
        audio_format = _WAVE_FORMAT_PCM
        frames = (np.clip(x, -1, 1) * 2147483647.0).astype("<i4").tobytes()
    elif bits == 8:
        audio_format = _WAVE_FORMAT_PCM
        frames = ((np.clip(x, -1, 1) * 127.0) + 128).astype(np.uint8).tobytes()
    else:
        raise ValueError(f"Unsupported bits_per_sample: {bits}")
    n_channels = x.shape[1]
    block_align = n_channels * bits // 8
    byte_rate = sample_rate * block_align
    header = b"RIFF" + struct.pack("<I", 36 + len(frames)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, audio_format, n_channels, sample_rate, byte_rate, block_align, bits)
    header += b"data" + struct.pack("<I", len(frames))
    with open(uri, "wb") as f:
        f.write(header + frames)
