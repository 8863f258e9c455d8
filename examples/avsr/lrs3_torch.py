"""LRS3 dataset and bucketing for the AVSR recipe on PyTorch (the host side of ``lrs3.py``).

Reads the layout that ``data_prep/preprocess_lrs3.py`` writes:

    root/
      labels/lrs3_{subset}_transcript_lengths_seg16s.csv   # dataset,relpath,frames,tokens
      <dataset>/video_seg/...npy      # (T, H, W) float32 or uint8 mouth ROIs
      <dataset>/audio_seg/...wav      # 16 kHz mono, aligned to the video
      <dataset>/text_seg/...txt       # transcript

Everything here is numpy on the host.  The WAV segments are read by ``load_audio`` through the port's
``audio_tpu_torch.io.load`` (PCM 8, 16, 24 and 32 bit, IEEE float 32 and 64 bit, WAVE_FORMAT_EXTENSIBLE), normalised
to float32 as the JAX package's ``load`` gives them; it raises on a rate other than 16 kHz.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from audio_tpu_torch import io

SAMPLE_RATE = 16000
_CSV = {
    "train": "lrs3_train_transcript_lengths_seg16s.csv",
    "val": "lrs3_test_transcript_lengths_seg16s.csv",
    "test": "lrs3_test_transcript_lengths_seg16s.csv",
}


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


def load_audio(path: str) -> np.ndarray:
    """A 16 kHz WAV file's samples, (L,) float32 (the channels one after another), read by the port's ``io.load``."""
    x, sr = io.load(path)
    if sr != SAMPLE_RATE:
        raise ValueError(f"expected {SAMPLE_RATE} Hz audio, got {sr} Hz in {path}")
    return x.numpy().reshape(-1)


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
