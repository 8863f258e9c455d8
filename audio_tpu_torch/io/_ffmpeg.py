"""FFmpeg-CLI decoding for the containers the built-in codecs do not read (mp3, ogg, opus, m4a, ...).

The same fallback as ``audio_tpu.io._ffmpeg``: torchaudio decodes compressed audio through torchcodec, which drives
FFmpeg; this package decodes WAV/FLAC/SPHERE/AU itself and, for anything else, runs an ``ffmpeg`` binary and reads
``f32le`` PCM back from it, and ``ffprobe`` (where there is one) for metadata.

The binary is looked up on ``PATH`` only.  The JAX package also takes a path from a shell variable of its own; the
port reads no shell variable to choose a path, so it does not.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = ["ffmpeg_available", "decode_with_ffmpeg", "probe_with_ffmpeg"]

def _binary(name: str = "ffmpeg") -> Optional[str]:
    return shutil.which(name)


def ffmpeg_available() -> bool:
    return _binary("ffmpeg") is not None


def decode_with_ffmpeg(data: bytes, format: Optional[str] = None) -> Tuple[np.ndarray, int]:
    """Decode ``data`` to float32 PCM via the ffmpeg CLI.

    Returns ``(waveform [time, channel] float32, sample_rate)``.
    """
    exe = _binary("ffmpeg")
    if exe is None:
        raise RuntimeError("no ffmpeg binary on PATH")
    rate, channels = _probe_stream(data, format)
    cmd = [exe, "-v", "error"]
    if format:
        cmd += ["-f", format]
    cmd += ["-i", "pipe:0", "-f", "f32le", "-acodec", "pcm_f32le", "pipe:1"]
    proc = subprocess.run(cmd, input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if proc.returncode != 0 or not proc.stdout:
        raise RuntimeError(f"ffmpeg decode failed: {proc.stderr.decode('utf-8', 'replace').strip()}")
    pcm = np.frombuffer(proc.stdout, dtype="<f4")
    usable = (len(pcm) // channels) * channels
    return pcm[:usable].reshape(-1, channels), rate


def _probe_stream(data: bytes, format: Optional[str] = None) -> Tuple[int, int]:
    """(sample_rate, channels) of the first audio stream."""
    meta = probe_with_ffmpeg(data, format)
    return meta["sample_rate"], meta["num_channels"]


def probe_with_ffmpeg(data: bytes, format: Optional[str] = None) -> dict:
    """Metadata dict for the first audio stream: sample_rate, num_channels,
    num_frames (0 if unknown), bits_per_sample (0 for lossy), encoding."""
    exe = _binary("ffprobe")
    if exe is not None:
        cmd = [exe, "-v", "error", "-show_streams", "-select_streams", "a:0", "-of", "json"]
        if format:
            cmd += ["-f", format]
        cmd += ["pipe:0"]
        proc = subprocess.run(cmd, input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        if proc.returncode == 0 and proc.stdout:
            streams = json.loads(proc.stdout.decode("utf-8", "replace")).get("streams") or []
            if streams:
                s = streams[0]
                rate = int(s.get("sample_rate", 0) or 0)
                dur = float(s.get("duration", 0.0) or 0.0)
                return {
                    "sample_rate": rate,
                    "num_channels": int(s.get("channels", 1) or 1),
                    "num_frames": int(round(dur * rate)) if dur and rate else 0,
                    "bits_per_sample": int(s.get("bits_per_raw_sample", 0) or 0),
                    "encoding": (s.get("codec_name") or "unknown").upper(),
                }
    # No ffprobe: decode a short prefix with ffmpeg itself, asking for WAV out
    # so the header carries rate/channels.
    exe = _binary("ffmpeg")
    if exe is None:
        raise RuntimeError("no ffprobe/ffmpeg binary on PATH")
    cmd = [exe, "-v", "error"]
    if format:
        cmd += ["-f", format]
    cmd += ["-i", "pipe:0", "-f", "wav", "-t", "0.05", "pipe:1"]
    proc = subprocess.run(cmd, input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if proc.returncode != 0 or len(proc.stdout) < 36:
        raise RuntimeError(f"ffmpeg probe failed: {proc.stderr.decode('utf-8', 'replace').strip()}")
    hdr = proc.stdout
    import struct

    channels, rate = struct.unpack_from("<HI", hdr, 22)
    return {
        "sample_rate": rate,
        "num_channels": channels,
        "num_frames": 0,
        "bits_per_sample": 0,
        "encoding": "UNKNOWN",
    }
