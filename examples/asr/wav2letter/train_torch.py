#!/usr/bin/env python3
"""Wav2Letter CTC training on PyTorch + CUDA (the port of ``train.py``).

    python3 examples/asr/wav2letter/train_torch.py --synthetic --tiny --steps 2 --device cpu
    python3 examples/asr/wav2letter/train_torch.py --synthetic --tiny --steps 120 --overfit

The step: ``featurize`` (``transforms.MFCC``, 13 coefficients of 40 mels, n_fft 400, hop 160: kernel K2 on the
card; then each utterance's coefficients normalised by their mean and population deviation over the frames, and
the frame counts ``wav_lens // 160 + 1``) -> ``Wav2Letter(29, "mfcc", 13)`` (23.3M parameters) -> the output
lengths scaled to the stride-2 stack -> ``ops.ctc.ctc_loss(blank 0, reduction="mean")`` -> backward -> optax's
``clip_by_global_norm(5.0)`` -> Adadelta (lr 0.6, rho 0.9, eps 1e-6, optax's and torch's defaults alike).
``decode`` is the greedy CTC decode and ``cer`` the character error rate from ``F.edit_distance``.  The weights
are drawn as flax's ``init`` draws the JAX recipe's (``audio_tpu_torch/_internal/init.py``'s ``flax_init_``).  Metrics
are JSON lines on stdout, as the JAX recipe prints them.  One card.  ``--librispeech-path`` (an extracted
LibriSpeech root, ``--librispeech-url`` its subset) reads real data through the port's ``datasets.LIBRISPEECH``,
batched as the JAX recipe's ``LibriSpeechBatches`` batches it.  ``--tiny`` is accepted as the JAX recipe accepts
it: Wav2Letter has no smaller configuration.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import sys
import time
from typing import Tuple

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", "..", ".."))

from audio_tpu_torch._internal.init import flax_init_  # noqa: E402
from audio_tpu_torch._internal.scripts import deterministic_cudnn, load_by_path  # noqa: E402

conformer_rnnt = load_by_path("conformer_rnnt_train_torch", os.path.join(_HERE, "..", "conformer_rnnt",
                                                                         "train_torch.py"))

import audio_tpu_torch.functional as F  # noqa: E402
from audio_tpu_torch.models import Wav2Letter  # noqa: E402
from audio_tpu_torch.ops.ctc import ctc_greedy_decode, ctc_loss  # noqa: E402
from audio_tpu_torch.transforms import MFCC  # noqa: E402

SAMPLE_RATE = 16000
LABELS = "_ abcdefghijklmnopqrstuvwxyz'"  # 0 = blank, as in the JAX recipe
N_MFCC, N_MELS, N_FFT, HOP = 13, 40, 400, 160
BLANK = 0
CLIP_NORM, LEARNING_RATE, RHO, EPS = 5.0, 0.6, 0.9, 1e-6
to_device = conformer_rnnt.to_device


class SyntheticBatches:
    """``train.py``'s synthetic data from a numpy seed: 0.1-scaled noise clips of ``audio_seconds``, each valid
    for half to all of its samples, and 3 to ``max_tgt_len - 1`` targets in [1, V) zero-padded to the longest."""

    def __init__(self, batch_size: int, num_classes: int, audio_seconds: float = 1.0, seed: int = 0,
                 max_tgt_len: int = 8):
        self.batch_size, self.num_classes = batch_size, num_classes
        self.audio_len = int(audio_seconds * SAMPLE_RATE)
        self.rng = np.random.default_rng(seed)
        self.max_tgt_len = max_tgt_len

    def __iter__(self):
        while True:
            b = self.batch_size
            wav = (0.1 * self.rng.standard_normal((b, self.audio_len))).astype(np.float32)
            wav_lens = self.rng.integers(self.audio_len // 2, self.audio_len + 1, b)
            tgt_len = self.rng.integers(3, self.max_tgt_len, b)
            tgt = self.rng.integers(1, self.num_classes, (b, int(tgt_len.max())))
            tgt = tgt * (np.arange(tgt.shape[1])[None] < tgt_len[:, None])
            yield wav, wav_lens.astype(np.int32), tgt.astype(np.int32), tgt_len.astype(np.int32)


class LibriSpeechBatches:
    """``train.py``'s LibriSpeech batches: one pass over the subset in a seed-0 permutation, each clip cut to
    ``max_seconds`` and zero-padded to it, its transcript lower-cased and kept to ``LABELS`` (a clip with no
    character left is skipped), the targets zero-padded to the longest; numpy arrays, as ``SyntheticBatches``."""

    def __init__(self, root, url, batch_size, max_seconds=8.0):
        from audio_tpu_torch.datasets import LIBRISPEECH

        self.ds = LIBRISPEECH(root, url=url, download=False)
        self.batch_size = batch_size
        self.max_len = int(max_seconds * SAMPLE_RATE)
        self.vocab = {c: i for i, c in enumerate(LABELS)}

    def __iter__(self):
        order = np.random.default_rng(0).permutation(len(self.ds))
        batch = []
        for i in order:
            wav, sr, text, *_ = self.ds[int(i)]
            wav = wav.numpy().reshape(-1)[: self.max_len]
            tokens = [self.vocab[c] for c in text.lower() if c in self.vocab]
            if tokens:
                batch.append((wav, tokens))
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []

    def _collate(self, batch):
        wav_lens = np.array([len(w) for w, _ in batch], np.int32)
        tgt_lens = np.array([len(t) for _, t in batch], np.int32)
        wav = np.zeros((len(batch), self.max_len), np.float32)
        tgt = np.zeros((len(batch), int(tgt_lens.max())), np.int32)
        for k, (w, t) in enumerate(batch):
            wav[k, : len(w)] = w
            tgt[k, : len(t)] = t
        return wav, wav_lens, tgt, tgt_lens


def make_mfcc(device="cuda") -> MFCC:
    """The recipe's front end: 13 MFCCs of 40 mels, n_fft 400, hop 160."""
    return MFCC(sample_rate=SAMPLE_RATE, n_mfcc=N_MFCC, melkwargs={"n_fft": N_FFT, "hop_length": HOP,
                                                                   "n_mels": N_MELS}, device=device)


def make_model(device="cuda", generator: torch.Generator = None) -> Wav2Letter:
    """``Wav2Letter(29, "mfcc", 13)``, drawn from ``generator`` as flax's ``init`` draws (when one is given)."""
    model = Wav2Letter(num_classes=len(LABELS), input_type="mfcc", num_features=N_MFCC, device=device)
    if generator is not None:
        flax_init_(model, generator)
    return model


def featurize(mfcc: MFCC, wav: torch.Tensor, wav_lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, samples) waveforms -> (per-utterance normalised MFCCs (B, 13, T), frame counts): the mean and the
    population deviation (``jnp.std``'s) over all T frames, padding included, as the JAX recipe takes them."""
    with torch.no_grad():
        feats = mfcc(wav)
        mean = feats.mean(dim=-1, keepdim=True)
        std = feats.std(dim=-1, keepdim=True, correction=0) + 1e-5
        return (feats - mean) / std, torch.div(wav_lens, HOP, rounding_mode="floor") + 1


def out_lens(feat_lens: torch.Tensor, t_in: int, t_out: int) -> torch.Tensor:
    """The frames of each clip after the stride-2 stack."""
    return torch.clamp(torch.div(feat_lens * t_out, t_in, rounding_mode="floor") + 1, max=t_out)


def log_probs(model: Wav2Letter, feats: torch.Tensor, feat_lens: torch.Tensor):
    """(log-probabilities (B, T', 29), their valid frames)."""
    logp = model(feats).transpose(1, 2)
    return logp, out_lens(feat_lens, feats.shape[-1], logp.shape[1])


class TrainStep:
    """One optimizer step over (features, feature lengths, targets, target lengths); returns the loss and the
    log-probabilities.  ``params`` holds the model's parameters by name; Adadelta updates them in place."""

    def __init__(self, model: Wav2Letter, learning_rate: float = LEARNING_RATE):
        self.model = model
        self.params = dict(model.named_parameters())
        self.optimizer = torch.optim.Adadelta(self.params.values(), lr=learning_rate, rho=RHO, eps=EPS)

    def loss(self, feats, feat_lens, targets, target_lengths):
        logp, in_lens = log_probs(self.model, feats, feat_lens)
        return ctc_loss(logp, targets, in_lens, target_lengths, blank=BLANK, reduction="mean"), logp

    def __call__(self, *batch):
        self.optimizer.zero_grad(set_to_none=True)
        loss, logp = self.loss(*batch)
        loss.backward()
        conformer_rnnt.clip_by_global_norm_(self.params.values(), CLIP_NORM)
        self.optimizer.step()
        return loss.detach(), logp.detach()


def decode(logp: torch.Tensor, lengths: torch.Tensor):
    """Greedy CTC tokens (B, T') padded with -1 and their counts."""
    return ctc_greedy_decode(logp, lengths, blank=BLANK)


def cer(tokens, counts, targets, target_lengths) -> float:
    """Characters edited over reference characters, summed over the batch."""
    tokens, counts, targets, target_lengths = (np.asarray(t.cpu()) for t in (tokens, counts, targets, target_lengths))
    err = total = 0
    for i in range(len(target_lengths)):
        ref = targets[i, : target_lengths[i]].tolist()
        err += F.edit_distance(tokens[i, : counts[i]].tolist(), ref)
        total += max(len(ref), 1)
    return err / max(total, 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=LEARNING_RATE, help="Adadelta's rate, as in the recipe")
    p.add_argument("--tiny", action="store_true", help="accepted as the JAX recipe accepts it; the model is the same")
    p.add_argument("--synthetic", action="store_true", help="random waveforms and targets from seed 0")
    p.add_argument("--librispeech-path", default=None)
    p.add_argument("--librispeech-url", default="train-clean-100")
    p.add_argument("--decode-every", type=int, default=50)
    p.add_argument("--overfit", action="store_true",
                   help="learning gate: train on ONE fixed batch, then assert the loss is below 1.0 and the greedy "
                        "decode's CER over the batch below 0.5")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    # the gate's verdict must not hang on the order of cuDNN's sums
    with deterministic_cudnn() if args.overfit else contextlib.nullcontext():
        return run(args)


def run(args: argparse.Namespace) -> int:
    """``main``'s training run (and ``--overfit``'s gate) with its parsed arguments."""
    dev = torch.device(args.device)
    num_classes = len(LABELS)
    if args.synthetic or args.librispeech_path is None:
        # the gate memorises a fixed batch of short clips, as the JAX recipe's does
        data = SyntheticBatches(args.global_batch, num_classes, audio_seconds=0.25 if args.overfit else 1.0,
                                max_tgt_len=4 if args.overfit else 8)
    else:
        data = LibriSpeechBatches(args.librispeech_path, args.librispeech_url, args.global_batch)
    model = make_model(dev, torch.Generator().manual_seed(0))
    mfcc = make_mfcc(dev)
    step = TrainStep(model, args.learning_rate)
    n_params = sum(v.numel() for v in step.params.values())
    print(json.dumps({"event": "init", "params_m": round(n_params / 1e6, 3), "device": str(dev)}))

    it = iter(data)
    if args.overfit:
        fixed = next(it)
        it = itertools.repeat(fixed)  # the same batch forever
    t0 = time.time()
    loss = float("nan")
    for i in range(args.steps):
        wav, wav_lens, tgt, tgt_lens = to_device(next(it), dev)
        feats, feat_lens = featurize(mfcc, wav, wav_lens)
        loss_t, logp = step(feats, feat_lens, tgt, tgt_lens)
        loss = float(loss_t)
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {i}: loss {loss}")
        rec = {"event": "step", "step": i, "loss": round(loss, 4), "elapsed_s": round(time.time() - t0, 1)}
        if i % args.decode_every == 0 or i == args.steps - 1:
            tokens, counts = decode(logp, out_lens(feat_lens, feats.shape[-1], logp.shape[1]))
            ref = "".join(LABELS[c] for c in tgt[0, : tgt_lens[0]].tolist())
            hyp = "".join(LABELS[c] for c in tokens[0, : counts[0]].tolist())
            rec["cer"] = round(F.edit_distance(list(ref), list(hyp)) / max(len(ref), 1), 4)
            rec["sample_hyp"] = hyp[:60]
        print(json.dumps(rec))

    if args.overfit:
        wav, wav_lens, tgt, tgt_lens = to_device(fixed, dev)
        feats, feat_lens = featurize(mfcc, wav, wav_lens)
        with torch.no_grad():
            logp, in_lens = log_probs(model, feats, feat_lens)
        rate = cer(*decode(logp, in_lens), tgt, tgt_lens)
        print(json.dumps({"event": "overfit_gate", "cer": round(rate, 4), "final_loss": round(loss, 4)}))
        if loss > 1.0 or rate > 0.5:
            raise AssertionError(f"learning gate failed: loss {loss:.4f} (need < 1.0), memorized-batch CER "
                                 f"{rate:.4f} (need < 0.5) after {args.steps} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
