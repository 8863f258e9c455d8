#!/usr/bin/env python3
"""Conv-TasNet source-separation training on PyTorch + CUDA (the port of ``train.py``).

    python3 examples/source_separation/train_torch.py --synthetic --tiny --steps 2 --device cpu
    python3 examples/source_separation/train_torch.py --synthetic --tiny --steps 150 --overfit --learning-rate 2e-3

The step: the mixture is the sum of the sources -> ``ConvTasNet`` (``conv_tasnet_base``, 4,984,881 parameters, or the
``--tiny`` debug model) -> utterance-level permutation-invariant negative Si-SNR (``pit_neg_si_snr``) -> backward
-> optax's ``clip_by_global_norm(5.0)`` -> Adam (lr 1e-3, optax's and torch's betas and epsilon alike).  The
weights are drawn as flax's ``init`` draws the JAX recipe's (``audio_tpu_torch/_internal/init.py``'s ``flax_init_``).
One card.  ``--librimix-path`` (a root holding ``Libri{2,3}Mix/``; ``--librimix-subset``, ``--seconds``) trains on real
mixtures through the port's ``datasets.LibriMix``, cropped and batched as the JAX recipe's ``LibriMixBatches`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import math
import os
import sys
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))

from audio_tpu_torch._internal.init import flax_init_  # noqa: E402
from audio_tpu_torch._internal.scripts import deterministic_cudnn, load_by_path  # noqa: E402

conformer_rnnt = load_by_path("conformer_rnnt_train_torch", os.path.join(_HERE, "..", "asr", "conformer_rnnt",
                                                                         "train_torch.py"))

from audio_tpu_torch.models import ConvTasNet, conv_tasnet_base  # noqa: E402

SAMPLE_RATE = 8000
CLIP_NORM, LEARNING_RATE = 5.0, 1e-3


def si_snr(estimate: torch.Tensor, reference: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB over the last axis."""
    ref = reference - reference.mean(dim=-1, keepdim=True)
    est = estimate - estimate.mean(dim=-1, keepdim=True)
    proj = (torch.sum(est * ref, dim=-1, keepdim=True) / (torch.sum(ref**2, dim=-1, keepdim=True) + eps)) * ref
    noise = est - proj
    return 10.0 * torch.log10((torch.sum(proj**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps))


def pit_neg_si_snr(estimates: torch.Tensor, references: torch.Tensor) -> torch.Tensor:
    """Permutation-invariant negative Si-SNR of (B, S, T) estimates against (B, S, T) references: each clip takes
    the permutation of the estimates with the best mean Si-SNR; the negative of that, averaged over the batch."""
    perms = list(itertools.permutations(range(estimates.shape[1])))
    scores = torch.stack([si_snr(estimates[:, list(p)], references).mean(dim=-1) for p in perms], dim=-1)
    return -scores.max(dim=-1).values.mean()


class LibriMixBatches:
    """``train.py``'s LibriMix batches through ``datasets.LibriMix`` (8 kHz): each clip's sources cropped to
    ``seconds`` from a start on a whole second drawn from ``seed`` (torchaudio's recipe convention), a shorter clip
    zero-padded; clips in a permutation from the same generator, drawn anew each pass.  Numpy (B, S, T), the mixture
    left to the step (the sum of the sources, the sep_clean task)."""

    def __init__(self, root, batch_size, num_sources, subset="train-360", seconds=3.0, seed=0):
        from audio_tpu_torch.datasets import LibriMix

        self.ds = LibriMix(root, subset=subset, num_speakers=num_sources, sample_rate=SAMPLE_RATE)
        if len(self.ds) == 0:
            raise SystemExit(f"no mixtures found under {root}")
        self.batch_size = batch_size
        self.num_sources = num_sources
        self.n = int(seconds * SAMPLE_RATE)
        self.rng = np.random.default_rng(seed)

    def _crop(self, srcs):
        t = srcs[0].shape[-1]
        if t <= self.n:
            out = np.zeros((self.num_sources, self.n), np.float32)
            for i, s in enumerate(srcs):
                out[i, :t] = s.numpy().reshape(-1)
            return out
        start = int(self.rng.integers(0, (t - self.n) // SAMPLE_RATE + 1)) * SAMPLE_RATE
        return np.stack([s.numpy().reshape(-1)[start: start + self.n] for s in srcs])

    def __iter__(self):
        order = self.rng.permutation(len(self.ds))
        pos = 0
        while True:
            batch = []
            for _ in range(self.batch_size):
                if pos >= len(order):
                    order = self.rng.permutation(len(self.ds))
                    pos = 0
                _sr, _mixed, srcs = self.ds[int(order[pos])]
                pos += 1
                batch.append(self._crop(srcs))
            yield np.stack(batch)  # (B, S, T)


class SyntheticMixtures:
    """``train.py``'s random tone-and-noise sources (B, S, T) from a numpy seed; the mixture is their sum."""

    def __init__(self, batch_size: int, num_sources: int, seconds: float = 1.0, seed: int = 0):
        self.batch_size = batch_size
        self.num_sources = num_sources
        self.n = int(seconds * SAMPLE_RATE)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        t = np.arange(self.n) / SAMPLE_RATE
        while True:
            freqs = self.rng.uniform(100, 3500, (self.batch_size, self.num_sources))
            phase = self.rng.uniform(0, 2 * np.pi, freqs.shape)
            src = 0.5 * np.sin(2 * np.pi * freqs[..., None] * t + phase[..., None])
            src = src + 0.01 * self.rng.standard_normal(src.shape)
            yield src.astype(np.float32)


def tiny_model(num_sources: int = 2, device="cuda") -> ConvTasNet:
    """The debug model of ``train.py --tiny``."""
    return ConvTasNet(num_sources=num_sources, enc_kernel_size=16, enc_num_feats=32, msk_kernel_size=3,
                      msk_num_feats=16, msk_num_hidden_feats=32, msk_num_layers=2, msk_num_stacks=2,
                      msk_activate="sigmoid", device=device)


def make_model(tiny: bool, num_sources: int = 2, device="cuda", generator: torch.Generator = None) -> ConvTasNet:
    """The recipe's model, drawn from ``generator`` as flax's ``init`` draws (when one is given)."""
    model = tiny_model(num_sources, device) if tiny else conv_tasnet_base(num_sources, device=device)
    if generator is not None:
        flax_init_(model, generator)
    return model


def mixture_of(sources: torch.Tensor) -> torch.Tensor:
    return sources.sum(dim=1, keepdim=True)


class TrainStep:
    """One optimizer step over (B, S, T) sources; returns the loss.  ``params`` holds the model's parameters by
    name; Adam updates them in place."""

    def __init__(self, model: ConvTasNet, learning_rate: float = LEARNING_RATE):
        self.model = model
        self.params = dict(model.named_parameters())
        self.optimizer = torch.optim.Adam(self.params.values(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def loss(self, sources: torch.Tensor) -> torch.Tensor:
        return pit_neg_si_snr(self.model(mixture_of(sources)), sources)

    def __call__(self, sources: torch.Tensor) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(sources)
        loss.backward()
        conformer_rnnt.clip_by_global_norm_(self.params.values(), CLIP_NORM)
        self.optimizer.step()
        return loss.detach()


def si_snr_improvement(model: ConvTasNet, sources: torch.Tensor):
    """(Si-SNR of the separated sources, of the mixture against each source, their difference), in dB."""
    with torch.no_grad():
        mixture = mixture_of(sources)
        si_est = -float(pit_neg_si_snr(model(mixture), sources))
        si_mix = float(si_snr(mixture.expand_as(sources), sources).mean())
    return si_est, si_mix, si_est - si_mix


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--num-sources", type=int, default=2)
    p.add_argument("--learning-rate", type=float, default=LEARNING_RATE)
    p.add_argument("--tiny", action="store_true", help="the 2 x 2-block debug model")
    p.add_argument("--synthetic", action="store_true", help="random tone-and-noise sources from seed 0")
    p.add_argument("--librimix-path", default=None, help="root containing Libri{2,3}Mix/ (LibriMix corpus)")
    p.add_argument("--librimix-subset", default="train-360")
    p.add_argument("--seconds", type=float, default=3.0, help="the crop of real data (torchaudio's recipe: 3 s)")
    p.add_argument("--overfit", action="store_true",
                   help="learning gate: train on ONE fixed batch, then assert the separation improves Si-SNR over "
                        "the input mixture by more than 5 dB")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.synthetic and not args.librimix_path:
        p.error("pass --synthetic or --librimix-path")

    # the gate's verdict must not hang on the order of cuDNN's sums
    with deterministic_cudnn() if args.overfit else contextlib.nullcontext():
        return run(args)


def run(args: argparse.Namespace) -> int:
    """``main``'s training run (and ``--overfit``'s gate) with its parsed arguments."""
    dev = torch.device(args.device)
    if args.librimix_path:
        data = LibriMixBatches(args.librimix_path, args.global_batch, args.num_sources, subset=args.librimix_subset,
                               seconds=args.seconds)
        print(f"LibriMix: {len(data.ds)} mixtures")
    else:
        data = SyntheticMixtures(args.global_batch, args.num_sources)
    model = make_model(args.tiny, args.num_sources, dev, torch.Generator().manual_seed(0))
    step = TrainStep(model, args.learning_rate)
    print(f"params: {sum(v.numel() for v in step.params.values()) / 1e6:.2f}M on {dev}")

    it = iter(data)
    if args.overfit:
        fixed = next(it)
        it = itertools.repeat(fixed)  # the same batch forever
    t0 = time.time()
    for i in range(args.steps):
        loss = float(step(torch.as_tensor(next(it)).to(dev)))
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {i}: loss {loss}")
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i}: neg-si-snr {loss:.4f} dB  ({time.time() - t0:.1f}s)")

    if args.overfit:
        si_est, si_mix, si_snri = si_snr_improvement(model, torch.as_tensor(fixed).to(dev))
        print(f"overfit_gate: si_snr {si_est:.2f} dB  mixture {si_mix:.2f} dB  si_snri {si_snri:.2f} dB")
        if si_snri < 5.0:
            raise AssertionError(f"memorization gate failed: Si-SNRi {si_snri:.2f} dB < 5 dB after {args.steps} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
