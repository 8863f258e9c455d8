#!/usr/bin/env python3
"""Tacotron2 training on PyTorch + CUDA (the port of ``train.py``).

    python3 examples/tts/tacotron2/train_torch.py --synthetic --tiny --steps 2 --device cpu
    python3 examples/tts/tacotron2/train_torch.py --synthetic --tiny --steps 500 --overfit --learning-rate 3e-3

The step: characters -> ``Tacotron2`` (torchaudio's widths, or the ``--tiny`` debug model), teacher forced with the
prenet's dropout on (its masks from a ``torch.Generator``) -> the masked MSE of the mel and of the postnet mel over
each clip's frames, plus the masked binary cross-entropy of the gate against a target that is 1 from the last frame
on -> backward -> AdamW (optax's ``adamw``: betas 0.9, 0.999, epsilon 1e-8, the decay on every parameter).  As in the
JAX recipe, the BatchNorms train on their running statistics (the model never moves them).  The weights are drawn as
flax's ``init`` draws the JAX recipe's (``flax_init_``: lecun-normal kernels, orthogonal recurrent matrices of the
decoder's cells, zero biases; the encoder's LSTM all lecun-normal, as the JAX ``_BiLSTM``).  ``log_mel`` is the
LJSpeech loader's target: ``MelSpectrogram(22050 Hz, n_fft 1024, hop 256, 80 mels, power 1)`` (kernel K2 on the
card), clamped at 1e-5, log.  One card.  ``--ljspeech-path`` (an extracted LJSpeech-1.1 root) trains on it through
the port's ``datasets.LJSPEECH``, batched as the JAX recipe's ``LJSpeechBatches`` batches it.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import math
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as nnF

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", "..", ".."))

from audio_tpu_torch._internal.init import LECUN_STD, flax_init_  # noqa: E402
from audio_tpu_torch._internal.scripts import deterministic_cudnn  # noqa: E402
from audio_tpu_torch.models import Tacotron2  # noqa: E402
from audio_tpu_torch.transforms import MelSpectrogram  # noqa: E402

SAMPLE_RATE = 22050
N_MELS = 80
HOP = 256
N_FFT = 1024
LEARNING_RATE, WEIGHT_DECAY = 1e-3, 1e-6
MAX_TEXT, MAX_FRAMES = 128, 512  # the LJSpeech loader's caps
GATE_MEL_MSE, GATE_STOP_ACC = 0.05, 1.0  # --overfit: the most mel MSE and the least stop-token accuracy

# character set used by the reference recipe's text preprocessor
SYMBOLS = "_-!'(),.:;? abcdefghijklmnopqrstuvwxyz"


def text_to_sequence(text: str) -> list:
    table = {c: i for i, c in enumerate(SYMBOLS)}
    return [table[c] for c in text.lower() if c in table]


def tiny_model(n_symbol: int, device="cuda", dtype=None) -> Tacotron2:
    """The debug model of ``train.py --tiny``."""
    return Tacotron2(n_symbol=n_symbol, n_mels=N_MELS, symbol_embedding_dim=32, encoder_embedding_dim=32,
                     encoder_n_convolution=1, encoder_kernel_size=3, decoder_rnn_dim=32, attention_rnn_dim=32,
                     attention_hidden_dim=16, attention_location_n_filter=4, attention_location_kernel_size=7,
                     prenet_dim=16, postnet_n_convolution=2, postnet_kernel_size=3, postnet_embedding_dim=32,
                     device=device, dtype=dtype)


def make_model(tiny: bool, n_symbol: int = len(SYMBOLS), device="cuda", dtype=None,
               generator: Optional[torch.Generator] = None) -> Tacotron2:
    """The recipe's model, drawn from ``generator`` as flax's ``init`` draws the JAX recipe's (when one is given)."""
    model = (tiny_model(n_symbol, device, dtype) if tiny
             else Tacotron2(n_symbol=n_symbol, n_mels=N_MELS, device=device, dtype=dtype))
    if generator is not None:
        flax_init_(model, generator)
        with torch.no_grad():  # the JAX encoder's _BiLSTM draws its recurrent matrices lecun-normal too
            for name, p in model.encoder.lstm.named_parameters():
                if name.startswith("weight_hh"):
                    std = p.shape[1] ** -0.5 / LECUN_STD
                    draw = torch.empty(p.shape, device=generator.device)
                    p.copy_(torch.nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=generator))
    return model


class SyntheticBatches:
    """``train.py``'s random batches from a numpy seed: tokens (B, text_len) zero past each clip's length, lengths,
    mels (B, 80, mel_len) of unit normals, frame counts."""

    def __init__(self, batch_size: int, n_symbol: int, text_len: int = 24, mel_len: int = 64, seed: int = 0):
        self.batch_size, self.n_symbol = batch_size, n_symbol
        self.text_len, self.mel_len = text_len, mel_len
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        while True:
            b = self.batch_size
            tok_len = self.rng.integers(self.text_len // 2, self.text_len + 1, b)
            tok = self.rng.integers(1, self.n_symbol, (b, self.text_len))
            tok = tok * (np.arange(self.text_len)[None] < tok_len[:, None])
            mel_len = self.rng.integers(self.mel_len // 2, self.mel_len + 1, b)
            mel = self.rng.standard_normal((b, N_MELS, self.mel_len)).astype(np.float32)
            yield tok.astype(np.int32), tok_len.astype(np.int32), mel, mel_len.astype(np.int32)


def make_melspec(device="cuda") -> MelSpectrogram:
    return MelSpectrogram(sample_rate=SAMPLE_RATE, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS, power=1.0,
                          device=device)


def log_mel(melspec: MelSpectrogram, wav: torch.Tensor) -> torch.Tensor:
    """The LJSpeech loader's target of (..., n) waveforms: log of the magnitude mel, clamped at 1e-5."""
    return torch.log(torch.clamp(melspec(wav), min=1e-5))


def collate(tokens: list, mels: list) -> Tuple[np.ndarray, ...]:
    """The LJSpeech loader's batch: each clip's tokens cut at ``MAX_TEXT`` and its (80, T) mel at ``MAX_FRAMES``, zero
    padded -> (tokens, token lengths, mels, frame counts)."""
    tokens = [t[:MAX_TEXT] for t in tokens]
    mels = [m[:, :MAX_FRAMES] for m in mels]
    tok_lens = np.array([len(t) for t in tokens], np.int32)
    mel_lens = np.array([m.shape[1] for m in mels], np.int32)
    tok = np.zeros((len(tokens), int(tok_lens.max())), np.int32)
    mel = np.zeros((len(mels), N_MELS, int(mel_lens.max())), np.float32)
    for k, (t, m) in enumerate(zip(tokens, mels)):
        tok[k, : len(t)] = t
        mel[k, :, : m.shape[1]] = m
    return tok, tok_lens, mel, mel_lens


class LJSpeechBatches:
    """``train.py``'s character-level LJSpeech batches through ``datasets.LJSPEECH``: epochs in seed-0 permutations
    (so a corpus smaller than a batch still trains), a clip whose text keeps no symbol skipped, the tokens of the
    normalised transcript and the ``log_mel`` target (on ``device``), cut and padded by ``collate``."""

    def __init__(self, root, batch_size, device="cuda"):
        from audio_tpu_torch.datasets import LJSPEECH

        self.ds = LJSPEECH(root, download=False)
        self.batch_size = batch_size
        self.melspec = make_melspec(device)
        self.device = device

    def __iter__(self):
        rng = np.random.default_rng(0)
        batch = []
        while True:
            for i in rng.permutation(len(self.ds)):
                wav, _, _, text = self.ds[int(i)]
                tokens = text_to_sequence(text)
                if not tokens:
                    continue
                batch.append((tokens, log_mel(self.melspec, wav.reshape(-1).to(self.device)).cpu().numpy()))
                if len(batch) == self.batch_size:
                    yield collate(*zip(*batch))
                    batch = []


def masks(mel: torch.Tensor, mel_lens: torch.Tensor):
    """(valid frames (B, T) in the mel's type, the gate's target: 1 from each clip's last frame on)."""
    frames = torch.arange(mel.shape[-1], device=mel.device)[None, :]
    return (frames < mel_lens[:, None]).to(mel.dtype), (frames >= (mel_lens - 1)[:, None]).to(mel.dtype)


def loss_of(outputs, mel: torch.Tensor, mel_lens: torch.Tensor) -> torch.Tensor:
    """``train.py``'s loss: the masked MSE of the mel and of the postnet mel, plus the masked gate BCE."""
    mel_out, mel_post, gate_out, _ = outputs
    valid, gate_tgt = masks(mel, mel_lens)
    denom = torch.clamp(valid.sum() * N_MELS, min=1.0)
    mse1 = (((mel_out - mel) ** 2) * valid[:, None, :]).sum() / denom
    mse2 = (((mel_post - mel) ** 2) * valid[:, None, :]).sum() / denom
    bce = nnF.binary_cross_entropy_with_logits(gate_out, gate_tgt, reduction="none")
    return mse1 + mse2 + (bce * valid).sum() / torch.clamp(valid.sum(), min=1.0)


class TrainStep:
    """One optimizer step over a batch (tokens, token lengths, mels, frame counts) on the model's device; returns the
    loss.  ``prenet_dropout`` draws its masks from ``generator``."""

    def __init__(self, model: Tacotron2, learning_rate: float = LEARNING_RATE, weight_decay: float = WEIGHT_DECAY,
                 prenet_dropout: bool = True):
        self.model = model
        self.params = dict(model.named_parameters())
        self.prenet_dropout = prenet_dropout
        self.optimizer = torch.optim.AdamW(self.params.values(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)

    def loss(self, batch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens, tok_lens, mel, mel_lens = batch
        outputs = self.model(tokens, tok_lens, mel, mel_lens, prenet_dropout=self.prenet_dropout, generator=generator)
        return loss_of(outputs, mel, mel_lens)

    def __call__(self, batch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch, generator)
        loss.backward()
        self.optimizer.step()
        return loss.detach()


def overfit_batch(batch) -> tuple:
    """``train.py --overfit``'s fixed batch: the batch's tokens and lengths with rank-1 smooth mel targets (numpy seed
    7: a random vector over the mels times a sine over the frames)."""
    tok, tl, mel, ml = batch
    g = np.random.default_rng(7)
    u = g.standard_normal((len(tl), N_MELS, 1)).astype(np.float32)
    v = np.sin(np.linspace(0, 3 * np.pi, mel.shape[-1]))[None, None, :].astype(np.float32)
    return tok, tl, (u * v).astype(np.float32), ml


def overfit_metrics(model: Tacotron2, batch) -> Tuple[float, float]:
    """(the postnet mel's masked MSE, the share of clips whose every valid frame's stop token is right) of the
    teacher-forced outputs without prenet dropout."""
    tokens, tok_lens, mel, mel_lens = batch
    with torch.no_grad():
        _, mel_post, gate_out, _ = model(tokens, tok_lens, mel, mel_lens, prenet_dropout=False)
    valid, gate_tgt = masks(mel, mel_lens)
    mse = float((((mel_post - mel) ** 2) * valid[:, None, :]).sum() / torch.clamp(valid.sum() * N_MELS, min=1.0))
    right = torch.where(valid > 0, (torch.sigmoid(gate_out) > 0.5) == (gate_tgt > 0), True)
    return mse, float(right.all(dim=1).double().mean())


def to_device(batch, dev) -> tuple:
    tok, tl, mel, ml = batch
    return (torch.as_tensor(tok, dtype=torch.int64, device=dev), torch.as_tensor(tl, dtype=torch.int64, device=dev),
            torch.as_tensor(mel, device=dev), torch.as_tensor(ml, dtype=torch.int64, device=dev))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=LEARNING_RATE)
    p.add_argument("--weight-decay", type=float, default=WEIGHT_DECAY)
    p.add_argument("--tiny", action="store_true", help="the debug model (widths 16-32)")
    p.add_argument("--synthetic", action="store_true", help="random batches from numpy seed 0")
    p.add_argument("--ljspeech-path", default=None, help="an extracted LJSpeech-1.1 root")
    p.add_argument("--overfit", action="store_true",
                   help="memorization gate: train on ONE fixed batch with prenet dropout off, then assert the "
                        "teacher-forced mel reconstruction collapses and the stop-token is predicted exactly")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.synthetic and args.ljspeech_path is None:
        p.error("pass --synthetic or --ljspeech-path")
    # the gate's verdict must not hang on the order of cuDNN's sums
    with deterministic_cudnn() if args.overfit else contextlib.nullcontext():
        return run(args)


def run(args: argparse.Namespace) -> int:
    """``main``'s training run (and ``--overfit``'s gate) with its parsed arguments."""
    dev = torch.device(args.device)
    if args.synthetic:
        data = SyntheticBatches(args.global_batch, len(SYMBOLS))
    else:
        data = LJSpeechBatches(args.ljspeech_path, args.global_batch, dev)
    model = make_model(args.tiny, len(SYMBOLS), dev, generator=torch.Generator().manual_seed(0))
    step = TrainStep(model, args.learning_rate, args.weight_decay, prenet_dropout=not args.overfit)
    print(f"params: {sum(v.numel() for v in step.params.values()) / 1e6:.2f}M on {dev}")

    it = iter(data)
    if args.overfit:
        fixed = to_device(overfit_batch(next(it)), dev)
        it = itertools.repeat(None)
    generator = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    loss = float("nan")
    for i in range(args.steps):
        batch = fixed if args.overfit else to_device(next(it), dev)
        loss = step(batch, generator)
        if i % 10 == 0 or i == args.steps - 1:  # the host reads the loss only here, and then checks it
            loss = float(loss)
            if not math.isfinite(loss):
                raise FloatingPointError(f"step {i}: loss {loss}")
            print(f"step {i}: loss {loss:.4f}  ({time.time() - t0:.1f}s)")

    if args.overfit:
        mse, gate_acc = overfit_metrics(model, fixed)
        print(f"overfit_gate: mel_mse {mse:.4f}  gate_acc {gate_acc:.3f}  final_loss {loss:.4f}")
        if mse > GATE_MEL_MSE or gate_acc < GATE_STOP_ACC:
            raise AssertionError(f"memorization gate failed: mel_mse {mse:.4f} (need <= {GATE_MEL_MSE}), stop-token "
                                 f"accuracy {gate_acc:.3f} (need {GATE_STOP_ACC}) after {args.steps} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
