"""LRS3 dataset and bucketing for the AVSR recipe on PyTorch (the host side of ``lrs3.py``).

Reads the layout that ``data_prep/preprocess_lrs3.py`` writes:

    root/
      labels/lrs3_{subset}_transcript_lengths_seg16s.csv   # dataset,relpath,frames,tokens
      <dataset>/video_seg/...npy      # (T, H, W) float32 or uint8 mouth ROIs
      <dataset>/audio_seg/...wav      # 16 kHz mono, aligned to the video
      <dataset>/text_seg/...txt       # transcript

Everything here is numpy on the host.  The WAV segments are read by ``load_audio``, a numpy reader of the
RIFF/WAVE files the preprocessing writes (PCM 8, 16, 24 and 32 bit, IEEE float 32 and 64 bit, and
WAVE_FORMAT_EXTENSIBLE), normalised to float32 as the JAX package's ``load`` gives them; it raises on a rate
other than 16 kHz.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

SAMPLE_RATE = 16000
_CSV = {
    "train": "lrs3_train_transcript_lengths_seg16s.csv",
    "val": "lrs3_test_transcript_lengths_seg16s.csv",
    "test": "lrs3_test_transcript_lengths_seg16s.csv",
}
_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _load_list(root: str, filename: str) -> Tuple[List[str], List[int]]:
    """Label csv lines ``dataset,relpath,input_length[,token_length]``, the relpath pointing at video_seg."""
    files, lengths = [], []
    with open(os.path.join(root, "labels", filename)) as f:
        for line in f.read().splitlines():
            if not line.strip():
                continue
            parts = line.split(",")
            dataset, rel_path, input_length = parts[0], parts[1], parts[2]
            base = os.path.splitext(rel_path)[0]
            files.append(os.path.normpath(os.path.join(root, dataset, base + ".npy")))
            lengths.append(int(input_length))
    return files, lengths


def load_video(path: str) -> np.ndarray:
    """(T, H, W) float32 in [0, 1]."""
    vid = np.load(path)
    if vid.dtype == np.uint8:
        vid = vid.astype(np.float32) / 255.0
    return np.asarray(vid, np.float32)


def _parse_wav(data: bytes):
    """(fmt fields, sample bytes) of a RIFF/WAVE file."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    pos = 12
    fmt = None
    frames = None
    while pos + 8 <= len(data):
        chunk_id = data[pos: pos + 4]
        (chunk_size,) = struct.unpack("<I", data[pos + 4: pos + 8])
        body = data[pos + 8: pos + 8 + chunk_size]
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


def _decode(fmt, frames: bytes) -> Tuple[np.ndarray, int]:
    """(samples (frames, channels) float32 in [-1, 1), sample rate)."""
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 8:
            x = (np.frombuffer(frames, dtype=np.uint8).astype(np.int16) - 128).astype(np.float32) / 128.0
        elif bits == 16:
            x = np.frombuffer(frames, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(frames, dtype=np.uint8).reshape(-1, 3)
            raw = b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) | (b[:, 2].astype(np.int32) << 16)
            raw = ((raw << 8) >> 8) << 8  # sign-extend, left-justify as int32
            x = raw.astype(np.float32) / 2147483648.0
        elif bits == 32:
            x = np.frombuffer(frames, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        x = np.frombuffer(frames, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAV format code: {audio_format:#x}")
    return x.reshape(-1, n_channels), sample_rate


def load_audio(path: str) -> np.ndarray:
    """A 16 kHz WAV file's samples, (L,) float32 (the channels one after another)."""
    with open(path, "rb") as f:
        x, sr = _decode(*_parse_wav(f.read()))
    if sr != SAMPLE_RATE:
        raise ValueError(f"expected {SAMPLE_RATE} Hz audio, got {sr} Hz in {path}")
    return np.ascontiguousarray(x.T).reshape(-1)


def load_transcript(video_path: str) -> str:
    txt = video_path.replace("video_seg", "text_seg")[: -len(".npy")] + ".txt"
    with open(txt) as f:
        return f.read().splitlines()[0]


class LRS3:
    """Items are (audio (L,), video (T, H, W), transcript) for audiovisual, or (audio/video, transcript) for
    one modality."""

    def __init__(self, root: str, subset: str = "train", modality: str = "audiovisual"):
        if subset not in _CSV:
            raise ValueError(f"subset must be one of {sorted(_CSV)}")
        if modality not in ("audio", "video", "audiovisual"):
            raise ValueError("modality must be audio, video, or audiovisual")
        self.root = root
        self.modality = modality
        self.files, self.lengths = _load_list(root, _CSV[subset])

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, n: int):
        path = self.files[n]
        transcript = load_transcript(path)
        if self.modality == "video":
            return load_video(path), transcript
        audio = load_audio(path.replace("video_seg", "audio_seg")[: -len(".npy")] + ".wav")
        if self.modality == "audio":
            return audio, transcript
        return audio, load_video(path), transcript


def batch_by_token_count(
    lengths: Sequence[int],
    max_frames: int,
    batch_size: Optional[int] = None,
    num_buckets: int = 50,
    shuffle: bool = False,
    seed: int = 0,
) -> List[List[int]]:
    """Bucketize by length, then greedily pack batches up to ``max_frames`` total frames (and at most
    ``batch_size`` items when one is given)."""
    lengths = np.asarray(lengths)
    if lengths.max() > max_frames:
        raise ValueError(f"max_frames {max_frames} < longest utterance {lengths.max()}")
    edges = np.linspace(lengths.min(), lengths.max(), num_buckets)
    bucket = np.digitize(lengths, edges)
    order = np.arange(len(lengths))
    if shuffle:
        order = np.random.default_rng(seed).permutation(order)
    else:
        order = order[np.argsort(-lengths[order], kind="stable")]
    order = order[np.argsort(bucket[order], kind="stable")]

    batches, cur, cur_count = [], [], 0
    for idx in order:
        n = int(lengths[idx])
        if (cur_count + n > max_frames) or (batch_size and len(cur) == batch_size):
            if cur:
                batches.append(cur)
            cur, cur_count = [int(idx)], n
        else:
            cur.append(int(idx))
            cur_count += n
    if cur:
        batches.append(cur)
    return batches
