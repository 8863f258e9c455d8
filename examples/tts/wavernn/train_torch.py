#!/usr/bin/env python3
"""WaveRNN vocoder training on PyTorch + CUDA (the port of ``train.py``).

    python3 examples/tts/wavernn/train_torch.py --synthetic --tiny --steps 2 --device cpu
    python3 examples/tts/wavernn/train_torch.py --synthetic --tiny --steps 400 --overfit --learning-rate 3e-3

The step: a waveform crop (B, 1, n hop + 1) and its log-mel (B, 1, 80, n + 4) -> ``WaveRNN`` teacher forced on the
crop's first n hop samples (the recipe's widths, or the ``--tiny`` debug model) -> the negative log-likelihood of the
next sample's mu-law class (256 classes) -> backward -> Adam (optax's ``adam``: betas 0.9, 0.999, epsilon 1e-8).  As in
the JAX recipe, the BatchNorms train on their running statistics (the model never moves them).  The weights are drawn
as flax's ``init`` draws the JAX recipe's (``flax_init_``), the upsampling kernels torchaudio's averages.
``log_mel`` is the LJSpeech loader's conditioning: ``MelSpectrogram(22050 Hz, n_fft 1024, hop 200, 80 mels, power 1)``
(kernel K2 on the card), clamped at 1e-5, log; ``crop`` cuts a clip as the loader does.  One card; only
``--synthetic`` data is wired up: ``--ljspeech-path`` waits for the port's dataset loaders.
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

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", "..", ".."))

import audio_tpu_torch.functional as F  # noqa: E402
from audio_tpu_torch._internal.init import flax_init_  # noqa: E402
from audio_tpu_torch._internal.scripts import deterministic_cudnn  # noqa: E402
from audio_tpu_torch.models import WaveRNN  # noqa: E402
from audio_tpu_torch.transforms import MelSpectrogram  # noqa: E402

SAMPLE_RATE = 22050
N_MELS = 80
HOP = 200  # must equal prod(upsample_scales)
N_FFT = 1024
N_BITS = 8
LEARNING_RATE = 1e-4
GATE_NLL, GATE_WITHIN1 = 1.0, 0.9  # --overfit: the most last loss, and the within-1 accuracy to beat


def make_model(tiny: bool, device="cuda", dtype=None, generator: Optional[torch.Generator] = None) -> WaveRNN:
    """The recipe's model (the reference recipe's defaults, or the debug model of ``train.py --tiny``), drawn from
    ``generator`` as flax's ``init`` draws the JAX recipe's (when one is given)."""
    widths = (dict(n_res_block=1, n_rnn=32, n_fc=32, n_hidden=16, n_output=32) if tiny else
              dict(n_res_block=10, n_rnn=512, n_fc=512, n_hidden=128, n_output=128))
    model = WaveRNN(upsample_scales=[5, 5, 8], n_classes=2**N_BITS, hop_length=HOP, kernel_size=5, n_freq=N_MELS,
                    device=device, dtype=dtype, **widths)
    if generator is not None:
        flax_init_(model, generator)
        model.upsample.reset_upsample_()
    return model


def quantize(wav: np.ndarray, n_bits: int = N_BITS) -> np.ndarray:
    """waveform in [-1, 1] -> integer classes [0, 2^bits)."""
    q = (wav + 1.0) * (2**n_bits - 1) / 2.0
    return np.clip(np.rint(q), 0, 2**n_bits - 1).astype(np.int32)


def dequantize(q: np.ndarray, n_bits: int = N_BITS) -> np.ndarray:
    return 2.0 * q.astype(np.float32) / (2**n_bits - 1.0) - 1.0


class SyntheticBatches:
    """``train.py``'s random (waveform crop, aligned mel) pairs from a numpy seed, shaped like the LJSpeech path:
    white noise, or with ``tonal`` sinusoids of 80-300 Hz (the learnable signal of the --overfit gate)."""

    def __init__(self, batch_size: int, n_frames: int = 12, seed: int = 0, tonal: bool = False):
        self.batch_size, self.n_frames = batch_size, n_frames
        self.rng = np.random.default_rng(seed)
        self.tonal = tonal

    def __iter__(self):
        while True:
            b, t = self.batch_size, self.n_frames
            # the conv stack trims kernel_size - 1 (= 4) frames; the model reads wav[:-1], (mel_frames - 4) hop samples
            mel = self.rng.standard_normal((b, 1, N_MELS, t + 4)).astype(np.float32)
            if self.tonal:
                ts = np.arange(t * HOP + 1) / SAMPLE_RATE
                f = self.rng.uniform(80, 300, (b, 1, 1))
                ph = self.rng.uniform(0, 2 * np.pi, (b, 1, 1))
                wav = 0.7 * np.sin(2 * np.pi * f * ts + ph)
            else:
                wav = np.clip(0.3 * self.rng.standard_normal((b, 1, t * HOP + 1)), -1, 1)
            yield wav.astype(np.float32), mel


def make_melspec(device="cuda") -> MelSpectrogram:
    return MelSpectrogram(sample_rate=SAMPLE_RATE, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS, power=1.0,
                          device=device)


def log_mel(melspec: MelSpectrogram, wav: torch.Tensor) -> torch.Tensor:
    """The LJSpeech loader's conditioning of (..., n) waveforms: log of the magnitude mel, clamped at 1e-5."""
    return torch.log(torch.clamp(melspec(wav), min=1e-5))


def crop(melspec: MelSpectrogram, wavs: torch.Tensor, starts, n_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LJSpeech loader's pairs from (B, n) clips and each one's start: the crop of (n_frames + 4) hop samples, its
    log-mel's first n_frames + 4 frames (B, 1, 80, n_frames + 4), and the waveform from two frames in, n_frames hop
    + 1 samples (B, 1, n_frames hop + 1)."""
    need = (n_frames + 4) * HOP
    crops = torch.stack([w[s: s + need] for w, s in zip(wavs, starts)])
    mels = log_mel(melspec, crops)[:, :, : n_frames + 4]
    return crops[:, None, 2 * HOP: (n_frames + 2) * HOP + 1], mels[:, None]


def nll_of(logits: torch.Tensor, wav: torch.Tensor) -> torch.Tensor:
    """The mean negative log-likelihood of each next sample's mu-law class."""
    target = F.mu_law_encoding(wav[:, :, 1:], 2**N_BITS).to(torch.int64)
    return -torch.log_softmax(logits, dim=-1).gather(-1, target[..., None]).mean()


class TrainStep:
    """One Adam step over (waveform (B, 1, L + 1), mel (B, 1, 80, T)) on the model's device; returns the loss."""

    def __init__(self, model: WaveRNN, learning_rate: float = LEARNING_RATE):
        self.model = model
        self.params = dict(model.named_parameters())
        self.optimizer = torch.optim.Adam(self.params.values(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def loss(self, wav: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        return nll_of(self.model(wav[:, :, :-1], mel), wav)

    def __call__(self, wav: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(wav, mel)
        loss.backward()
        self.optimizer.step()
        return loss.detach()


def overfit_metrics(model: WaveRNN, wav: torch.Tensor, mel: torch.Tensor) -> Tuple[float, float]:
    """(the argmax's exact accuracy, its accuracy within one class) on the next samples' mu-law classes."""
    with torch.no_grad():
        logits = model(wav[:, :, :-1], mel)
    err = (torch.argmax(logits, dim=-1) - F.mu_law_encoding(wav[:, :, 1:], 2**N_BITS).to(torch.int64)).abs()
    return float((err == 0).double().mean()), float((err <= 1).double().mean())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=LEARNING_RATE)
    p.add_argument("--tiny", action="store_true", help="the debug model (GRUs of 32)")
    p.add_argument("--synthetic", action="store_true", help="random crops from numpy seed 0")
    p.add_argument("--ljspeech-path", default=None, help="an extracted LJSpeech-1.1 root")
    p.add_argument("--overfit", action="store_true",
                   help="learning gate: train on ONE fixed batch and assert the memorized next-sample distribution "
                        "collapses (NLL < 1.0 nat and within-1-class accuracy > 0.9 over the 256 mu-law classes; "
                        "chance NLL is ln(256) = 5.5)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.ljspeech_path is not None:
        raise NotImplementedError("--ljspeech-path needs the LJSpeech loader, which the port does not have yet; "
                                  "pass --synthetic")
    if not args.synthetic:
        p.error("pass --synthetic or --ljspeech-path")
    # the gate's verdict must not hang on the order of cuDNN's sums
    with deterministic_cudnn() if args.overfit else contextlib.nullcontext():
        return run(args)


def run(args: argparse.Namespace) -> int:
    """``main``'s training run (and ``--overfit``'s gate) with its parsed arguments."""
    dev = torch.device(args.device)
    data = SyntheticBatches(args.global_batch, n_frames=6 if args.overfit else 12, tonal=args.overfit)
    model = make_model(args.tiny, dev, generator=torch.Generator().manual_seed(0))
    step = TrainStep(model, args.learning_rate)
    print(f"params: {sum(v.numel() for v in step.params.values()) / 1e6:.2f}M on {dev}")

    it = iter(data)
    if args.overfit:
        it = itertools.repeat(next(it))  # the same batch forever
    t0 = time.time()
    loss = float("nan")
    for i in range(args.steps):
        wav, mel = (torch.as_tensor(x, device=dev) for x in next(it))
        loss = step(wav, mel)
        if i % 10 == 0 or i == args.steps - 1:  # the host reads the loss only here, and then checks it
            loss = float(loss)
            if not math.isfinite(loss):
                raise FloatingPointError(f"step {i}: loss {loss}")
            print(f"step {i}: loss {loss:.4f}  ({time.time() - t0:.1f}s)")

    if args.overfit:
        acc, acc1 = overfit_metrics(model, wav, mel)
        print(f"overfit_gate: final_loss {loss:.4f}  argmax_acc {acc:.4f}  within1_acc {acc1:.4f}")
        if loss > GATE_NLL or acc1 < GATE_WITHIN1:
            raise AssertionError(f"memorization gate failed: loss {loss:.4f} (need < {GATE_NLL}), within-1-class "
                                 f"accuracy {acc1:.4f} (need > {GATE_WITHIN1}) after {args.steps} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
