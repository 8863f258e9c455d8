"""NIST SPHERE (.sph) and Sun AU (.au/.snd) readers.

The same readers as ``audio_tpu.io._formats``: torchaudio decodes these through torchcodec/FFmpeg; this package
reads them itself, so TED-LIUM (.sph) and GTZAN (.au) corpora load with no codec library.  Shorten-compressed SPHERE
payloads are not read (nor are they by FFmpeg without its shorten codec) and raise.  They return numpy arrays
(frames, channels); ``io.load`` hands them on as tensors.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

__all__ = ["parse_sph", "parse_au", "sph_info", "au_info", "MULAW_TABLE"]


def _ulaw_table() -> np.ndarray:
    u = np.arange(256, dtype=np.uint8)
    u = ~u
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    magnitude = ((mantissa.astype(np.int32) << 3) + 0x84) << exponent
    magnitude -= 0x84
    out = np.where(sign != 0, -magnitude, magnitude).astype(np.int16)
    return out


MULAW_TABLE = _ulaw_table()


def _sph_fields(data: bytes) -> dict:
    if not data.startswith(b"NIST_1A"):
        raise ValueError("Not a NIST SPHERE file")
    header_size = int(data[8:16].decode("ascii").strip())
    fields = {"_header_size": header_size}
    for line in data[16:header_size].decode("ascii", "replace").splitlines():
        parts = line.strip().split(None, 2)
        if not parts or parts[0] == "end_head":
            break
        if len(parts) == 3 and parts[1].startswith("-"):
            name, type_, value = parts
            if type_.startswith("-i"):
                fields[name] = int(value)
            else:
                fields[name] = value
    return fields


def sph_info(data: bytes) -> Tuple[int, int, int, int, str]:
    """Header-only metadata: (rate, frames, channels, bits, encoding)."""
    fields = _sph_fields(data)
    rate = int(fields.get("sample_rate", 16000))
    nch = int(fields.get("channel_count", 1))
    nbytes = int(fields.get("sample_n_bytes", 2))
    coding = str(fields.get("sample_coding", "pcm"))
    frames = int(fields.get("sample_count", 0))  # SPHERE: per-channel count
    enc = "ULAW" if coding.startswith("ulaw") else "PCM_S"
    return rate, frames, nch, 8 * nbytes, enc


def au_info(data: bytes) -> Tuple[int, int, int, int, str]:
    """Header-only metadata: (rate, frames, channels, bits, encoding)."""
    if data[:4] != b".snd":
        raise ValueError("Not a Sun AU file")
    offset, size, enc, rate, nch = struct.unpack(">IIIII", data[4:24])
    if size == 0xFFFFFFFF:
        size = len(data) - offset
    nbytes = {1: 1, 2: 1, 3: 2, 4: 3, 5: 4, 6: 4, 7: 8}.get(enc, 2)
    name = {1: "ULAW", 6: "PCM_F", 7: "PCM_F"}.get(enc, "PCM_S")
    frames = size // (nbytes * max(nch, 1))
    return rate, frames, nch, 8 * nbytes, name


def parse_sph(data: bytes) -> Tuple[np.ndarray, int, int, str]:
    """Decode NIST SPHERE -> (float32 (frames, channels), rate, bits, encoding)."""
    fields = _sph_fields(data)
    header_size = fields["_header_size"]
    rate = int(fields.get("sample_rate", 16000))
    nch = int(fields.get("channel_count", 1))
    nbytes = int(fields.get("sample_n_bytes", 2))
    coding = str(fields.get("sample_coding", "pcm"))
    byte_format = str(fields.get("sample_byte_format", "01"))
    body = data[header_size:]

    if "shorten" in coding or "embedded" in coding:
        raise ValueError(
            "SPHERE file uses embedded shorten compression; convert with "
            "`sph2pipe -f wav` first (the reference needs the same conversion)"
        )
    enc = "PCM_S"
    if coding.startswith("ulaw") or (coding == "pcm" and nbytes == 1 and "ulaw" in str(fields)):
        pcm = MULAW_TABLE[np.frombuffer(body, np.uint8)]
        x = pcm.astype(np.float32) / 32768.0
        bits = 8
        enc = "ULAW"
    elif nbytes == 2:
        dtype = "<i2" if byte_format == "01" else ">i2"
        pcm = np.frombuffer(body[: len(body) // 2 * 2], dtype)
        x = pcm.astype(np.float32) / 32768.0
        bits = 16
    elif nbytes == 1:
        pcm = np.frombuffer(body, np.int8)
        x = pcm.astype(np.float32) / 128.0
        bits = 8
    else:
        raise ValueError(f"Unsupported SPHERE sample_n_bytes={nbytes}")
    frames = x.size // nch
    return x[: frames * nch].reshape(-1, nch), rate, bits, enc


def parse_au(data: bytes) -> Tuple[np.ndarray, int, int, str]:
    """Decode Sun AU -> (float32 (frames, channels), rate, bits, encoding)."""
    if data[:4] != b".snd":
        raise ValueError("Not a Sun AU file")
    offset, _size, enc, rate, nch = struct.unpack(">IIIII", data[4:24])
    body = data[offset:]
    if enc == 1:  # 8-bit mu-law
        x = MULAW_TABLE[np.frombuffer(body, np.uint8)].astype(np.float32) / 32768.0
        bits, name = 8, "ULAW"
    elif enc == 2:
        x = np.frombuffer(body, np.int8).astype(np.float32) / 128.0
        bits, name = 8, "PCM_S"
    elif enc == 3:
        x = np.frombuffer(body[: len(body) // 2 * 2], ">i2").astype(np.float32) / 32768.0
        bits, name = 16, "PCM_S"
    elif enc == 4:
        b = np.frombuffer(body[: len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        raw = (b[:, 0].astype(np.int32) << 16) | (b[:, 1].astype(np.int32) << 8) | b[:, 2]
        raw = (raw << 8) >> 8
        x = raw.astype(np.float32) / 8388608.0
        bits, name = 24, "PCM_S"
    elif enc == 5:
        x = np.frombuffer(body[: len(body) // 4 * 4], ">i4").astype(np.float32) / 2147483648.0
        bits, name = 32, "PCM_S"
    elif enc == 6:
        x = np.frombuffer(body[: len(body) // 4 * 4], ">f4").astype(np.float32)
        bits, name = 32, "PCM_F"
    elif enc == 7:
        x = np.frombuffer(body[: len(body) // 8 * 8], ">f8").astype(np.float32)
        bits, name = 64, "PCM_F"
    else:
        raise ValueError(f"Unsupported AU encoding {enc}")
    frames = x.size // nch
    return x[: frames * nch].reshape(-1, nch), rate, bits, name
